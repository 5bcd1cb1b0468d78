"""End-to-end DEM -> freezing offline coupling.

The reference pipeline (README.md:103): DEM settle ->
``spheres_final_positions.txt`` (extract_final_positions.m) -> freezing
simulator builds the glass phase field from it (equation.c:474-529).
This drives the whole chain with this framework's own implementations:
spheres app -> write_final_positions -> intertrack app via
``ball_positions_file``.
"""

import os

import numpy as np
import pytest

from porousfreezethaw.apps.intertrack import main as intertrack_main
from porousfreezethaw.apps.spheres import main as spheres_main
from porousfreezethaw.cases import freezing_params_text
from porousfreezethaw.io.netcdf3 import read_netcdf
from porousfreezethaw.models.dem.coupling import write_final_positions
from porousfreezethaw.models.freezing.glass import read_ball_positions


class TestFinalPositionsWriter:
    def test_roundtrip_against_reader(self, tmp_path):
        pos = np.random.RandomState(0).random_sample((30, 3))
        path = tmp_path / "final.txt"
        write_final_positions(str(path), pos)

        class P:  # minimal params shim for the reader
            beads_scaling = 2.0
            beads_offset_x = 0.1
            beads_offset_y = 0.2
            beads_offset_z = 0.3

        back = read_ball_positions(str(path), P)
        np.testing.assert_allclose(
            back, pos * 2.0 + np.array([0.1, 0.2, 0.3]), rtol=0, atol=0)

    def test_reference_fixture_parses(self):
        # the writer's format must match the shipped reference data file
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        class P:
            beads_scaling = 1.0
            beads_offset_x = 0.0
            beads_offset_y = 0.0
            beads_offset_z = 0.0

        ref = read_ball_positions(
            os.path.join(repo, "data", "spheres_final_positions.txt"), P)
        assert ref.shape == (200, 3)


class TestDemToFreezing:
    @pytest.fixture(scope="class")
    def settled(self, tmp_path_factory):
        """A short DEM settle producing a final-positions file."""
        out = tmp_path_factory.mktemp("dem")
        final = out / "final_positions.txt"
        rc = spheres_main([
            "--variant", "friction_angular", "--n", "12", "--icond", "dense",
            "--snapshots", "4", "--final-time", "1.5",
            "--output", str(out), "--final-positions", str(final)])
        assert rc == 0
        return final

    def test_settle_produces_resting_bed(self, settled):
        pos = np.loadtxt(settled)
        assert pos.shape == (12, 3)
        # all spheres inside the unit box walls, settled low (they start
        # at h0=2 above the floor and must have fallen)
        r = 0.1
        assert np.all(pos[:, :2] > -0.5 - r) and np.all(pos[:, :2] < 1.5 + r)
        assert np.all(pos[:, 2] < 1.0)
        assert np.all(pos[:, 2] > 0.0)

    def test_freezing_consumes_own_bed(self, settled, tmp_path):
        params = freezing_params_text(grid_nodes=12, calc_mode=0,
                                      final_time_hours=5.0 / 3600.0,
                                      saved_files=2)
        # larger balls so the 12-sphere bed is resolvable on the 6x6x12
        # test grid (the default 0.1*beads_scaling is sub-cell here)
        params += (f"\nball_radius 0.3*beads_scaling"
                   f"\nset ball_positions_file = {settled}\n")
        pfile = tmp_path / "Params"
        pfile.write_text(params)
        old = os.environ.get("OUTPUT")
        os.environ["OUTPUT"] = str(tmp_path)
        try:
            rc = intertrack_main([str(pfile)])
        finally:
            if old is None:
                os.environ.pop("OUTPUT", None)
            else:
                os.environ["OUTPUT"] = old
        assert rc == 0
        data = read_netcdf(str(tmp_path / "image.001.ncd"))
        gl = np.asarray(data.variables["gl"])
        # the glass field contains the settled bed: solid cells present
        # in the lower half of the domain (the icond formula only puts
        # glass in the top lid, so anything solid down low IS the bed)
        assert 0.02 < gl.mean() < 0.9
        lower = gl[:gl.shape[0] // 2]
        assert lower.max() > 0.8
        assert 0.01 < lower.mean() < 0.9
