"""Multi-device tests on the virtual 8-device CPU mesh: sharded execution
must not change results (the reference's rank-count-invariance oracle:
identical step counts and fields for any decomposition, BASELINE.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.models.freezing import make_rhs
from porousfreezethaw.parallel.sharding import (
    freezing_sharding, make_mesh, shard_freezing_state)
from porousfreezethaw.solvers import MersonParams, merson_init, merson_solve

from tests.test_freezing_equation import default_params


def make_case(n3=16, n2=8, n1=8):
    geom = GridGeometry(0.03, 0.03, 0.06, n1, n2, n3)
    prm = default_params()
    rng = np.random.RandomState(5)
    u = 273.15 + 20 * (rng.random_sample(geom.shape) - 0.5)
    p = rng.random_sample(geom.shape)
    gl = rng.random_sample(geom.shape) * 0.5
    return geom, prm, np.stack([u, p, gl])


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


class TestMeshSpec:
    def test_specs(self):
        assert dict(make_mesh("z").shape) == {"z": 8}
        assert dict(make_mesh("z4,y2").shape) == {"z": 4, "y": 2}
        assert dict(make_mesh("z2,y4").shape) == {"z": 2, "y": 4}
        assert dict(make_mesh("z4").shape) == {"z": 4}

    def test_bad_specs(self):
        with pytest.raises(ValueError):
            make_mesh("z3,y3")  # 9 > 8 devices
        with pytest.raises(ValueError):
            make_mesh("z,y")    # two implicit axes
        with pytest.raises(ValueError):
            make_mesh("Z-1")

    def test_divisibility_check(self):
        mesh = make_mesh("z8")
        w = jnp.zeros((3, 12, 8, 8))
        with pytest.raises(ValueError):
            shard_freezing_state(w, mesh)


@pytest.mark.parametrize("spec", ["z8", "z4,y2", "z2,y4"])
def test_rhs_sharded_equals_single(spec):
    geom, prm, w0 = make_case()
    rhs = make_rhs(geom, prm, 0)
    w = jnp.asarray(w0)
    ref = np.asarray(jax.jit(rhs)(100.0, w))

    mesh = make_mesh(spec)
    ws = shard_freezing_state(w, mesh)
    out = jax.jit(rhs)(100.0, ws)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("spec", ["z8", "z2,y4"])
def test_merson_solve_sharded_step_counts_invariant(spec):
    """The full adaptive solve must produce identical step counts and
    fields (to fp tolerance) regardless of the device decomposition —
    the reference's strongest cross-configuration oracle."""
    geom, prm, w0 = make_case()
    rhs = make_rhs(geom, prm, 0)
    params = MersonParams(delta=1e-3, h_min=1e-9)

    st1 = merson_init(jnp.asarray(w0), 0.0, 1.0)
    st1, status1 = jax.jit(lambda s: merson_solve(rhs, s, 30.0, params))(st1)

    mesh = make_mesh(spec)
    ws = shard_freezing_state(jnp.asarray(w0), mesh)
    st2 = merson_init(ws, 0.0, 1.0)
    st2, status2 = jax.jit(lambda s: merson_solve(rhs, s, 30.0, params))(st2)

    assert int(status1) == int(status2) == 0
    assert int(st1.steps) == int(st2.steps)
    assert int(st1.steps_total) == int(st2.steps_total)
    np.testing.assert_allclose(np.asarray(st2.y), np.asarray(st1.y),
                               rtol=1e-12, atol=1e-14)
    # eps reduction order differs across shardings -> last-ulp differences
    # in the continuation step estimate (the same effect the reference's
    # master-rank-decides discipline exists to contain); steps must still
    # agree exactly above, h only to ~1e-10.
    assert float(st1.h) == pytest.approx(float(st2.h), rel=1e-9)


def test_output_keeps_sharding():
    geom, prm, w0 = make_case()
    rhs = make_rhs(geom, prm, 2)
    mesh = make_mesh("z4,y2")
    ws = shard_freezing_state(jnp.asarray(w0), mesh)
    out = jax.jit(rhs)(0.0, ws)
    assert out.sharding.is_equivalent_to(freezing_sharding(mesh), ndim=4)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[1].shape
    assert np.all(np.isfinite(np.asarray(out)))


class TestExplicitHalo:
    """shard_map + ppermute halo path == GSPMD == single device."""

    @pytest.mark.parametrize("mode", [0, 2])
    def test_shard_map_rhs_matches(self, mode):
        from porousfreezethaw.parallel.halo import (
            make_shard_map_rhs, shard_spec)
        geom, prm, w0 = make_case()
        rhs_ref = make_rhs(geom, prm, mode)
        want = np.asarray(jax.jit(rhs_ref)(100.0, jnp.asarray(w0)))

        mesh = make_mesh("z8")
        rhs_sm = make_shard_map_rhs(geom, prm, mode, mesh)
        ws = jax.device_put(jnp.asarray(w0), shard_spec(mesh))
        got = np.asarray(jax.jit(rhs_sm)(100.0, ws))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)

    def test_dirichlet_switch_through_shard_map(self):
        from porousfreezethaw.parallel.halo import (
            make_shard_map_rhs, shard_spec)
        geom, prm, w0 = make_case()
        mesh = make_mesh("z4")
        rhs_sm = make_shard_map_rhs(geom, prm, 0, mesh)
        ws = jax.device_put(jnp.asarray(w0), shard_spec(mesh))
        rhs_ref = make_rhs(geom, prm, 0)
        for t in (prm.phase_switch_time - 1, prm.phase_switch_time + 1):
            got = np.asarray(jax.jit(rhs_sm)(t, ws))
            want = np.asarray(jax.jit(rhs_ref)(t, jnp.asarray(w0)))
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)

    def test_merson_through_shard_map(self):
        from porousfreezethaw.parallel.halo import (
            make_shard_map_rhs, shard_spec)
        geom, prm, w0 = make_case()
        mesh = make_mesh("z8")
        rhs_sm = make_shard_map_rhs(geom, prm, 0, mesh)
        rhs_ref = make_rhs(geom, prm, 0)
        params = MersonParams(delta=1e-3, h_min=1e-9)

        st1, s1 = jax.jit(lambda s: merson_solve(rhs_ref, s, 30.0, params))(
            merson_init(jnp.asarray(w0), 0.0, 1.0))
        ws = jax.device_put(jnp.asarray(w0), shard_spec(mesh))
        st2, s2 = jax.jit(lambda s: merson_solve(rhs_sm, s, 30.0, params))(
            merson_init(ws, 0.0, 1.0))
        assert int(s1) == int(s2) == 0
        assert int(st1.steps) == int(st2.steps)
        assert int(st1.steps_total) == int(st2.steps_total)
        np.testing.assert_allclose(np.asarray(st2.y), np.asarray(st1.y),
                                   rtol=1e-12, atol=1e-14)


class TestDEMSharded:
    """Particle-sharded DEM: results must be mesh-size invariant (the
    reference DEM has no distributed mode at all —
    spheres_friction_angular.c:614-616)."""

    @staticmethod
    def _setup(n=16):
        from porousfreezethaw.models.dem import (
            DEMConfig, icond_dense)
        cfg = DEMConfig(variant="friction_angular", n=n, r=0.1, T=0.5,
                        snapshots=3)
        y0, _ = icond_dense(cfg, seed=3)
        return cfg, {k: jnp.asarray(v) for k, v in y0.items()}

    def test_rhs_sharded_equals_single(self):
        from porousfreezethaw.models.dem import make_dem_rhs
        from porousfreezethaw.parallel.sharding import shard_dem_state
        cfg, y0 = self._setup()
        rhs = make_dem_rhs(cfg)
        want = jax.jit(lambda y: rhs(0.0, y))(y0)
        mesh = make_mesh("p8")
        rhs_s = make_dem_rhs(cfg, mesh=mesh)
        ys = shard_dem_state(y0, mesh)
        got = jax.jit(lambda y: rhs_s(0.0, y))(ys)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))

    def test_merson_solve_mesh_invariant(self):
        from porousfreezethaw.models.dem import make_dem_rhs
        from porousfreezethaw.parallel.sharding import shard_dem_state
        cfg, y0 = self._setup()
        params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                              max_steps=4000)
        results = {}
        for spec in [None, "p2", "p8"]:
            if spec is None:
                y, rhs = y0, make_dem_rhs(cfg)
            else:
                mesh = make_mesh(spec)
                y = shard_dem_state(y0, mesh)
                rhs = make_dem_rhs(cfg, mesh=mesh)
            st = merson_init(y, 0.0, cfg.ht)
            out, status = jax.jit(
                lambda s, f=rhs: merson_solve(f, s, 0.25, params))(st)
            assert int(status) == 0
            results[spec] = (int(out.steps), int(out.steps_total),
                             {k: np.asarray(v) for k, v in out.y.items()})
        base_steps, base_total, base_y = results[None]
        assert base_steps > 3
        for spec in ["p2", "p8"]:
            steps, total, y = results[spec]
            # the reference's oracle: step counts identical for any
            # decomposition (SURVEY §4.2)
            assert (steps, total) == (base_steps, base_total)
            for k in base_y:
                # the rhs itself is bitwise identical (test above), but
                # the jitted while_loop AROUND it is a different XLA
                # program when partitioned: fusion/FMA-contraction
                # choices on the stage axpys differ, so fields agree to
                # rounding (~1e-15 observed over this horizon), not
                # bitwise
                np.testing.assert_allclose(y[k], base_y[k],
                                           rtol=1e-9, atol=1e-12)
