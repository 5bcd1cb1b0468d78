"""Integration tests for the intertrack application driver.

Tiny-grid CLI runs (via ``apps.intertrack.main``) in tmp dirs, covering
the integration seams of the reference driver (intertrack.c:1642-1669,
2265-2560): snapshot series production, ``continue_series`` resume
equality with an uninterrupted run, on-demand trigger numbering
``.NNN.MMM``, batch sweeps with mnemonics / ``continue_if``, and pproc
script execution.
"""

import os
import stat

import numpy as np
import pytest

from porousfreezethaw.apps.intertrack import main
from porousfreezethaw.cases import freezing_params_text
from porousfreezethaw.io.netcdf3 import read_netcdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BALLS = os.path.join(REPO, "data", "spheres_positions.txt")

# 6 x 6 x 12 grid, 5 s simulated, 3 snapshots: a complete freezing run in
# seconds on CPU
BASE = freezing_params_text(grid_nodes=12, calc_mode=0,
                            final_time_hours=5.0 / 3600.0, saved_files=3)
BASE += f"\nset ball_positions_file = {BALLS}\n"


def run_app(tmp_path, params_text, argv_extra=(), name="Params"):
    pfile = tmp_path / name
    pfile.write_text(params_text)
    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = str(tmp_path)
    try:
        rc = main([str(pfile), *argv_extra])
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
    return rc


class TestSnapshotSeries:
    def test_series_files_and_attrs(self, tmp_path):
        rc = run_app(tmp_path, BASE)
        assert rc == 0
        files = sorted(p.name for p in tmp_path.glob("image.*.ncd"))
        assert files == ["image.000.ncd", "image.001.ncd", "image.002.ncd"]
        log = (tmp_path / "intertrack.log").read_text()
        assert "completed successfully" in log

        for i, f in enumerate(files):
            data = read_netcdf(str(tmp_path / f))
            assert data.attrs["snapshot"] == i
            assert data.attrs["total_snapshots"] == 3
            assert data.attrs["final_time"] == pytest.approx(5.0)
            assert data.attrs["t"] == pytest.approx(5.0 * i / 2)
            assert data.variables["u"].shape == (12, 6, 6)
        # time advanced: the fields must differ between snapshots
        a = read_netcdf(str(tmp_path / files[0])).variables["u"]
        b = read_netcdf(str(tmp_path / files[2])).variables["u"]
        assert not np.array_equal(a, b)


class TestContinueSeries:
    def test_resume_equals_uninterrupted(self, tmp_path):
        full = tmp_path / "full"
        resumed = tmp_path / "resumed"
        full.mkdir()
        resumed.mkdir()
        assert run_app(full, BASE) == 0

        # resume from snapshot 001 into a fresh directory; snapshot 002
        # must be byte-identical to the uninterrupted run's
        # (intertrack.c:1642-1669: t, tau, snapshot index all restored
        # from the checkpoint attrs)
        resume_params = BASE + (
            f"\nset icond_file = {full}/image.001.ncd\n"
            "set continue_series\n")
        assert run_app(resumed, resume_params) == 0
        assert not (resumed / "image.000.ncd").exists()
        # the starting snapshot is re-written from the loaded state (the
        # reference loop starts at starting_snapshot) and must be
        # byte-identical to the checkpoint it came from
        assert ((resumed / "image.001.ncd").read_bytes()
                == (full / "image.001.ncd").read_bytes())
        got = (resumed / "image.002.ncd").read_bytes()
        want = (full / "image.002.ncd").read_bytes()
        assert got == want

        log = (resumed / "intertrack.log").read_text()
        assert "Series continuation mode has been requested." in log


class TestOnDemandTrigger:
    def test_trigger_numbering(self, tmp_path):
        # pre-create the trigger file: the very first accepted step of
        # snapshot 1's solve interrupts, producing image.000.000.ncd,
        # and the run then completes normally (intertrack.c:2283-2303)
        trigger = tmp_path / "t"
        trigger.write_text("")
        params = BASE + f"\nset snapshot_trigger = {trigger}\n"
        rc = run_app(tmp_path, params)
        assert rc == 0
        files = sorted(p.name for p in tmp_path.glob("image.*.ncd"))
        assert "image.000.000.ncd" in files          # on-demand .NNN.MMM
        assert {"image.000.ncd", "image.001.ncd",
                "image.002.ncd"} <= set(files)
        assert not trigger.exists()                  # deleted after writing

        od = read_netcdf(str(tmp_path / "image.000.000.ncd"))
        assert od.attrs["snapshot"] == 0
        assert 0.0 < od.attrs["t"] < 2.5             # mid-interval state


class TestBatchMode:
    def test_sweep_dirs_mnemonics_continue_if(self, tmp_path):
        # 3-iteration sweep; mnemonic names iterations 1/2; continue_if
        # skips iteration 2 entirely (intertrack.c:1377-1484)
        params = BASE + (
            "\nmnemonic 1: coarse medium fine\n"
            "continue_if i1 = 2\n")
        # reference CLI: param_file [master_rank] [ubound_list]
        rc = run_app(tmp_path, params, argv_extra=["0", "3"])
        assert rc == 0
        assert (tmp_path / "image_coarse" / "image.000_coarse.ncd").exists()
        assert (tmp_path / "image_fine" / "image.002_fine.ncd").exists()
        assert not (tmp_path / "image_medium").exists()
        log = (tmp_path / "intertrack.log").read_text()
        assert "ENTERING BATCH PROCESSING MODE" in log
        assert "Iteration 2 skipped" in log

    def test_loop_var_in_params(self, tmp_path):
        # loop variable visible to expressions: sweep the top temperature
        params = BASE + "\ntop_temp1 273.15 - 5*i1\n"
        rc = run_app(tmp_path, params, argv_extra=["0", "2"])
        assert rc == 0
        a = read_netcdf(str(tmp_path / "image_1" / "image.002_1.ncd"))
        b = read_netcdf(str(tmp_path / "image_2" / "image.002_2.ncd"))
        # different Dirichlet top temperature -> different final fields
        assert not np.array_equal(a.variables["u"], b.variables["u"])


class TestPostProcessing:
    def test_pproc_script_runs(self, tmp_path):
        script = tmp_path / "pproc.sh"
        marker = tmp_path / "pproc_ran"
        script.write_text(f"#!/bin/sh\necho \"$1\" > {marker}\n")
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        params = BASE + f"\nset pproc_script = {script}\n"
        rc = run_app(tmp_path, params)
        assert rc == 0
        # the script receives the output dir argument (intertrack.c:2572-2640)
        assert marker.read_text().strip().endswith("image")


class TestMasterRankCompat:
    def test_reference_cli_shape(self, tmp_path):
        # reference CLI: intertrack param_file [master_rank] [ubound_list];
        # a bare integer master_rank is accepted and ignored under SPMD
        rc = run_app(tmp_path, BASE, argv_extra=["0"])
        assert rc == 0
        assert (tmp_path / "image.002.ncd").exists()


class TestF32OverflowRecovery:
    def test_f32_big_tau_cold_start_completes(self, tmp_path):
        """An f32 run whose initial tau overflows the stage cascade must
        recover through the app's default NaN backoff instead of
        spinning at h = 0 forever (an on-device loop that never
        returns; the reference C solver loops forever in the same
        state — intertrack.c:2193 ships its recovery commented out,
        safe only in f64)."""
        # tau far above the stable step: the GradP cascade overflows f32
        params = BASE + "\ntau 1e6\n"
        rc = run_app(tmp_path, params, argv_extra=["--precision", "f32"])
        assert rc == 0
        log = (tmp_path / "intertrack.log").read_text()
        assert "completed successfully" in log
        data = read_netcdf(str(tmp_path / "image.002.ncd"))
        assert np.all(np.isfinite(data.variables["u"]))


def _log(path):
    return (path / "intertrack.log").read_text()


def _final_steps(log):
    import re
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    return int(m[1]), int(m[2])


def test_fused_interpret_paths_on_cpu(tmp_path):
    """An f32 run takes the production increment-form (delta) attempt on
    every platform — the code path a GPU run takes."""
    rc = run_app(tmp_path, BASE, ("--precision", "f32"))
    assert rc == 0
    log = _log(tmp_path)
    assert "Increment-form (delta) attempt: ON" in log
    assert "accept-side minimum h growth" not in log  # exact reference rule
    assert (tmp_path / "image.002.ncd").exists()
    u = read_netcdf(str(tmp_path / "image.002.ncd")).variables["u"]
    assert np.isfinite(np.asarray(u)).all()


def test_increment_form_opt_out_selects_classic(tmp_path):
    """`increment_form 0` restores the classic make_rhs stages and
    re-enables the documented noise-floor escape default."""
    rc = run_app(tmp_path, BASE + "\nincrement_form\t0\n",
                 ("--precision", "f32"))
    assert rc == 0
    log = _log(tmp_path)
    assert "Increment-form (delta) attempt" not in log
    assert "accept-side minimum h growth 1.05" in log
    assert (tmp_path / "image.002.ncd").exists()


def _compare_mesh_run(tmp_path, mesh, mesh_log):
    """f32 delta run on a mesh against the same run on one device: equal
    step counts and fields to f32 rounding.  The sharded program fuses
    differently (FMA contraction), so the fields are not bitwise."""
    single = tmp_path / "single"
    sharded = tmp_path / "sharded"
    single.mkdir()
    sharded.mkdir()
    assert run_app(single, BASE, ("--precision", "f32")) == 0
    assert run_app(sharded, BASE, ("--precision", "f32",
                                   "--mesh", mesh)) == 0
    log = _log(sharded)
    assert "Increment-form (delta) attempt: ON" in log
    assert mesh_log in log
    assert _final_steps(log) == _final_steps(_log(single))
    for name in ("image.001.ncd", "image.002.ncd"):
        a = read_netcdf(str(single / name))
        b = read_netcdf(str(sharded / name))
        for v in ("u", "p", "gl"):
            np.testing.assert_allclose(
                np.asarray(b.variables[v]), np.asarray(a.variables[v]),
                rtol=1e-5, atol=1e-5)


def test_fused_interpret_sharded_delta_matches_single(tmp_path):
    """The app under ``--mesh z4`` keeps the increment form and
    reproduces the single-device run (rank-count invariance, SURVEY
    §4.2), writing its snapshots gather-free."""
    _compare_mesh_run(tmp_path, "z4", "Device mesh: {'z': 4}")


def test_fused_interpret_2d_mesh(tmp_path):
    """The app under ``--mesh z2,y2`` (a 2-D decomposition the reference
    cannot do, intertrack.c:1780-1789) reproduces the single-device
    run."""
    _compare_mesh_run(tmp_path, "z2,y2", "Device mesh: {'z': 2, 'y': 2}")


@pytest.mark.parametrize("mesh", [None, "z2"])
@pytest.mark.parametrize("increment_form", [0, 1])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_attempt_choice(tmp_path, precision, increment_form, mesh):
    """The attempt depends on (precision, increment_form) alone, never on
    the platform or the mesh: f32 takes the increment form unless
    `increment_form 0`; f64 always runs the classic stages under the
    exact reference rule."""
    argv = ("--precision", precision) + (("--mesh", mesh) if mesh else ())
    params = BASE + f"\nincrement_form {increment_form}\n"
    assert run_app(tmp_path, params, argv) == 0
    log = _log(tmp_path)
    delta = precision == "f32" and increment_form == 1
    assert ("Increment-form (delta) attempt: ON" in log) == delta
    escape = precision == "f32" and increment_form == 0
    assert ("accept-side minimum h growth 1.05" in log) == escape
    assert ("Device mesh: {'z': 2}" in log) == (mesh is not None)
    assert "completed successfully" in log


def test_compensated_commit_is_an_error(tmp_path):
    """The removed compensated commit is refused by name, not silently
    replaced by another result."""
    rc = run_app(tmp_path, BASE + "\ncompensated_commit 1\n",
                 ("--precision", "f32"))
    assert rc == 1
    log = _log(tmp_path)
    assert "compensated_commit has been removed" in log
    assert not (tmp_path / "image.001.ncd").exists()
