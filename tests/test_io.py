"""Tests for the NetCDF classic writer/reader and the snapshot contract."""

import os

import numpy as np
import pytest

from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.io.netcdf3 import read_netcdf, write_netcdf
from porousfreezethaw.io.snapshots import (
    load_checkpoint, snapshot_filename, write_snapshot)
from porousfreezethaw.io.csv_snaps import (
    read_dem_snapshot, snapshot_path, write_dem_snapshot)

from tests.test_freezing_equation import default_params


class TestNetCDF3:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "x.ncd")
        rng = np.random.RandomState(0)
        data = rng.random_sample((4, 3, 2))
        coord = np.arange(4, dtype=np.float64)
        write_netcdf(
            path,
            dims={"n3": 4, "n2": 3, "n1": 2},
            variables=[("n3", ("n3",), coord),
                       ("u", ("n3", "n2", "n1"), data)],
            attrs={"t": 1.5, "snapshot": 3, "title": "hello world"},
        )
        out = read_netcdf(path)
        assert out.dims == {"n3": 4, "n2": 3, "n1": 2}
        np.testing.assert_array_equal(out.variables["u"], data)
        np.testing.assert_array_equal(out.variables["n3"], coord)
        assert out.attrs["t"] == 1.5
        assert out.attrs["snapshot"] == 3
        assert out.attrs["title"] == "hello world"
        assert out.var_dims["u"] == ("n3", "n2", "n1")

    def test_scipy_can_read_our_files(self, tmp_path):
        # cross-check with an independent reader (scipy's netcdf_file)
        scipy_io = pytest.importorskip("scipy.io")
        path = str(tmp_path / "y.ncd")
        data = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
        write_netcdf(path, {"a": 2, "b": 3, "c": 4},
                     [("v", ("a", "b", "c"), data)],
                     {"comment": "xcheck", "val": 2.25, "count": 7})
        with scipy_io.netcdf_file(path, "r", mmap=False) as f:
            np.testing.assert_array_equal(f.variables["v"][:], data)
            assert f.comment == b"xcheck"
            assert float(f.val) == 2.25
            assert int(f.count) == 7

    def test_we_can_read_scipy_files(self, tmp_path):
        scipy_io = pytest.importorskip("scipy.io")
        path = str(tmp_path / "z.nc")
        with scipy_io.netcdf_file(path, "w") as f:
            f.createDimension("n", 5)
            v = f.createVariable("field", "f8", ("n",))
            v[:] = np.linspace(0, 1, 5)
            f.some_attr = 42.0
        out = read_netcdf(path)
        np.testing.assert_allclose(out.variables["field"], np.linspace(0, 1, 5))
        assert out.attrs["some_attr"] == 42.0

    def test_int_variable(self, tmp_path):
        path = str(tmp_path / "i.ncd")
        write_netcdf(path, {"n": 3}, [("k", ("n",), np.array([1, 2, 3]))], {})
        out = read_netcdf(path)
        np.testing.assert_array_equal(out.variables["k"], [1, 2, 3])


class TestSnapshotContract:
    def test_filenames(self):
        assert snapshot_filename("/o/image", 7, ".ncd") == "/o/image.007.ncd"
        assert snapshot_filename("/o/image", 7, ".ncd", 2) == "/o/image.007.002.ncd"

    def test_snapshot_roundtrip(self, tmp_path):
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        fields = np.random.RandomState(1).random_sample((3,) + geom.shape)
        path = str(tmp_path / "image.000.ncd")
        write_snapshot(
            path, geom, prm, fields, calc_mode=0, delta=1e-3, tau=0.125,
            t=360.0, final_time=36000.0, snapshot=5, total_snapshots=100,
            comment="Testing run")
        ck = load_checkpoint(path)
        np.testing.assert_array_equal(ck.fields, fields)
        assert ck.t == 360.0 and ck.tau == 0.125
        assert ck.snapshot == 5 and ck.total_snapshots == 100
        assert ck.final_time == 36000.0
        assert ck.geom_dims == (4, 4, 8)
        # attribute inventory mirrors intertrack.c:2370-2406
        for key in ("L1", "L2", "L3", "u_star", "water_cp", "ball_radius",
                    "calc_mode", "delta", "tau", "t", "final_time",
                    "snapshot", "total_snapshots", "title"):
            assert key in ck.attrs, key
        assert ck.attrs["title"] == "Intertrack simulation (Testing run). Time: 360"

    def test_sharded_write_matches_gathered(self, tmp_path):
        """write_snapshot_sharded over the 8-device CPU mesh must produce
        a byte-identical file to the single-array write_snapshot."""
        import jax
        import jax.numpy as jnp

        from porousfreezethaw.io.snapshots import write_snapshot_sharded
        from porousfreezethaw.parallel.sharding import (
            make_mesh, shard_freezing_state)

        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        fields = np.random.RandomState(2).random_sample((3,) + geom.shape)
        kw = dict(calc_mode=0, delta=1e-3, tau=0.125, t=360.0,
                  final_time=36000.0, snapshot=5, total_snapshots=100,
                  comment="Sharded")

        ref_path = str(tmp_path / "ref.ncd")
        write_snapshot(ref_path, geom, prm, fields, **kw)

        for spec in ("z4,y2", "z8", "z2"):
            mesh = make_mesh(spec, devices=jax.devices()[:8])
            w = shard_freezing_state(jnp.asarray(fields), mesh)
            path = str(tmp_path / f"sharded_{spec.replace(',', '_')}.ncd")
            write_snapshot_sharded(path, geom, prm, w, **kw)
            assert open(path, "rb").read() == open(ref_path, "rb").read(), spec

    def test_block_writer_partial_runs(self, tmp_path):
        """write_block must handle blocks that do not span trailing dims."""
        from porousfreezethaw.io.netcdf3 import (
            NC_DOUBLE, create_netcdf, write_block)
        dims = {"a": 4, "b": 6, "c": 5}
        layouts = create_netcdf(str(tmp_path / "f.nc"), dims,
                                [("v", ("a", "b", "c"), NC_DOUBLE)], {})
        full = np.zeros((4, 6, 5))
        rng = np.random.RandomState(3)
        # disjoint hyperslabs covering the variable
        for (a0, na) in ((0, 2), (2, 2)):
            for (b0, nb) in ((0, 3), (3, 3)):
                for (c0, nc) in ((0, 5),):
                    blk = rng.random_sample((na, nb, nc))
                    full[a0:a0 + na, b0:b0 + nb, c0:c0 + nc] = blk
                    write_block(str(tmp_path / "f.nc"), layouts["v"], blk,
                                (a0, b0, c0))
        # partial last dim too
        blk = rng.random_sample((1, 1, 2))
        full[1:2, 1:2, 2:4] = blk
        write_block(str(tmp_path / "f.nc"), layouts["v"], blk, (1, 1, 2))
        got = read_netcdf(str(tmp_path / "f.nc")).variables["v"]
        np.testing.assert_array_equal(got, full)

    def test_coordinates_are_cell_centers(self, tmp_path):
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        path = str(tmp_path / "c.ncd")
        write_snapshot(path, geom, prm, np.zeros((3,) + geom.shape),
                       calc_mode=0, delta=1e-3, tau=1.0, t=0.0,
                       final_time=1.0, snapshot=0, total_snapshots=1)
        out = read_netcdf(path)
        # z_k = L3*(0.5+k)/total_n3 (intertrack.c:2444-2446, grid 'inner')
        np.testing.assert_allclose(
            out.variables["n3"], 0.06 * (0.5 + np.arange(8)) / 8)
        np.testing.assert_allclose(
            out.variables["n1"], 0.03 * (0.5 + np.arange(4)) / 4)


class TestDEMSnapshots:
    def test_angular_roundtrip(self, tmp_path):
        state = {
            "pos": np.array([[0.1, 0.2, 0.3]]),
            "vel": np.array([[1.0, 2.0, 3.0]]),
            "angvel": np.array([[-1.0, 0.5, 0.25]]),
        }
        path = snapshot_path(str(tmp_path), 1)
        assert path.endswith("snap_001.csv")
        write_dem_snapshot(path, state, np.array([0.3]), angular=True)
        cols = read_dem_snapshot(path)
        assert list(cols) == ["x", "y", "z", "vx", "vy", "vz",
                              "avx", "avy", "avz", "color"]
        assert cols["z"][0] == pytest.approx(0.3)
        assert cols["avx"][0] == pytest.approx(-1.0)

    def test_basic_header(self, tmp_path):
        state = {"pos": np.zeros((2, 3)), "vel": np.zeros((2, 3))}
        path = snapshot_path(str(tmp_path), 12)
        write_dem_snapshot(path, state, np.array([1.0, 2.0]), angular=False)
        with open(path) as f:
            assert f.readline().strip() == "x,y,z,color"
            assert len(f.readlines()) == 2


class TestGridFullMode:
    def test_full_grid_snapshot_has_ghost_layer(self, tmp_path):
        """grid full writes the bcond_thickness=2 ghost layer: mirror
        everywhere, Dirichlet value on both top-z temperature planes
        (intertrack.c:2338-2340, equation.c:113-263)."""
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        rng = np.random.RandomState(2)
        fields = rng.random_sample((3,) + geom.shape) + 270.0
        path = str(tmp_path / "full.ncd")
        write_snapshot(path, geom, prm, fields, calc_mode=0, delta=1e-3,
                       tau=1.0, t=100.0, final_time=1e4, snapshot=0,
                       total_snapshots=1, grid_mode="full")
        out = read_netcdf(path)
        assert out.dims == {"n3": 12, "n2": 8, "n1": 8}
        u = out.variables["u"]
        # x mirror: ghost[-1] = interior[0], ghost[-2] = interior[1]
        np.testing.assert_array_equal(u[2:-2, 2:-2, 1], fields[0][:, :, 0])
        np.testing.assert_array_equal(u[2:-2, 2:-2, 0], fields[0][:, :, 1])
        # z-top Dirichlet on both temperature ghost planes (t < switch)
        np.testing.assert_array_equal(u[-2:], prm.top_temp1)
        # p stays mirrored at the top
        p = out.variables["p"]
        np.testing.assert_array_equal(p[-1, 2:-2, 2:-2], fields[1][-2])
        # coordinates extend below zero (ghost cell centers)
        assert out.variables["n3"][0] == pytest.approx(
            0.06 * (0.5 - 2) / 8)

    def test_inner_default_unchanged(self, tmp_path):
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        fields = np.zeros((3,) + geom.shape)
        path = str(tmp_path / "inner.ncd")
        write_snapshot(path, geom, prm, fields, calc_mode=0, delta=1e-3,
                       tau=1.0, t=0.0, final_time=1.0, snapshot=0,
                       total_snapshots=1)
        assert read_netcdf(path).dims == {"n3": 8, "n2": 4, "n1": 4}

    @pytest.mark.parametrize(
        "spec", ["z8", "z4", "z2", "z2,y2", "z2,y4", "z4,y2"])
    def test_sharded_shifted_write_matches_gathered(self, tmp_path, spec):
        """An f32 state stored as u - u_star (the app's f32 layout),
        sharded over the CPU mesh, writes byte-identically to the
        gathered writer applied to the host-unshifted state: the per-shard
        u_shift add rounds exactly as the app's gathered path does."""
        import jax
        import jax.numpy as jnp

        from porousfreezethaw.io.snapshots import write_snapshot_sharded
        from porousfreezethaw.parallel.sharding import (
            make_mesh, shard_freezing_state)

        geom = GridGeometry(0.03, 0.03, 0.06, 5, 8, 8)
        prm = default_params()
        u_shift = 273.15
        fields = np.random.RandomState(3).random_sample(
            (3,) + geom.shape).astype(np.float32)
        kw = dict(calc_mode=0, delta=1e-3, tau=0.125, t=360.0,
                  final_time=36000.0, snapshot=5, total_snapshots=100,
                  comment="Sharded shifted")

        unshifted = np.array(fields, copy=True)
        unshifted[0] += u_shift
        ref_path = str(tmp_path / "ref.ncd")
        write_snapshot(ref_path, geom, prm, unshifted, **kw)

        mesh = make_mesh(spec, devices=jax.devices()[:8])
        w = shard_freezing_state(jnp.asarray(fields), mesh)
        path = str(tmp_path / "sharded.ncd")
        write_snapshot_sharded(path, geom, prm, w, u_shift=u_shift, **kw)
        assert open(path, "rb").read() == open(ref_path, "rb").read()

    def test_sharded_write_rejects_wrong_shape(self, tmp_path):
        import jax.numpy as jnp

        from porousfreezethaw.io.snapshots import write_snapshot_sharded

        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        with pytest.raises(ValueError, match="does not match the grid"):
            write_snapshot_sharded(
                str(tmp_path / "x.ncd"), geom, default_params(),
                jnp.zeros((3, 8, 4, 5)), calc_mode=0, delta=1e-3, tau=1.0,
                t=0.0, final_time=1.0, snapshot=0, total_snapshots=1)
