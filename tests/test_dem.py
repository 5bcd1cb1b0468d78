"""DEM force-kernel tests vs closed-form two-body cases and an independent
NumPy loop transcription of the reference force model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.models.dem import (
    DEMConfig, icond_2spheres, icond_dense, icond_sparse, make_dem_rhs)
from porousfreezethaw.solvers import MersonParams, merson_init, merson_solve


def numpy_dem_rhs(cfg, y):
    """Per-particle loop implementation following the force equations
    (spheres_friction_angular.c:242-357) — the independent oracle."""
    pos = np.asarray(y["pos"]); vel = np.asarray(y["vel"])
    angvel = np.asarray(y["angvel"]) if "angvel" in y else None
    n = pos.shape[0]
    P_w, n_w = cfg.wall_arrays()
    kef = cfg.COR**2
    I = cfg.inertia

    def rebound(v):
        return kef + 0.5 * (1 - kef) * (1 + np.tanh(v * cfg.dissipation_focusing))

    def colf(s):
        if cfg.variant == "basic_WB":
            return 0.0 if s > 0 else -cfg.WB_stiffness * s
        return cfg.collision_force_multiplier * np.exp(-cfg.collision_force_exponent * s)

    def ffac(x):
        if x >= cfg.p_eps1:
            return 1.0
        return x * x * (3 / cfg.p_eps1**2 - 2 / cfg.p_eps1**3 * x)

    acc = np.tile(np.asarray(cfg.gravity, float), (n, 1))
    angacc = np.zeros((n, 3))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            mp = pos[i] - pos[j]
            dist = np.linalg.norm(mp) + cfg.zero
            mp = mp / dist
            surf = dist - 2 * cfg.r
            if surf > cfg.max_surf_dist:
                continue
            CF = colf(surf)
            mv = vel[i] - vel[j]
            heading = mv @ mp
            acc[i] += CF * rebound(-heading) * mp
            if cfg.has_friction:
                mvt = mv - heading * mp
                if angvel is not None:
                    mvt = mvt - cfg.r * np.cross(angvel[i], mp)
                    mvt = mvt - cfg.r * np.cross(angvel[j], mp)
                mag = np.linalg.norm(mvt) + cfg.zero
                tdir = mvt / mag
                FF = CF * cfg.friction * ffac(mag)
                acc[i] -= FF * tdir
                if angvel is not None:
                    angacc[i] += cfg.r * FF / I * np.cross(mp, tdir)
        for w in range(len(P_w)):
            mp = pos[i] - P_w[w]
            surf = -(mp @ n_w[w]) - cfg.r
            if surf > cfg.max_surf_dist:
                continue
            CF = colf(surf)
            heading = vel[i] @ n_w[w]
            acc[i] -= CF * rebound(heading) * n_w[w]
            if cfg.has_friction:
                mvt = vel[i] - heading * n_w[w]
                if angvel is not None:
                    mvt = mvt + cfg.r * np.cross(angvel[i], n_w[w])
                mag = np.linalg.norm(mvt) + cfg.zero
                tdir = mvt / mag
                FF = CF * cfg.friction * ffac(mag)
                acc[i] -= FF * tdir
                if angvel is not None:
                    angacc[i] -= cfg.r * FF / I * np.cross(n_w[w], tdir)

    out = {"pos": vel.copy(), "vel": acc}
    if angvel is not None:
        out["angvel"] = angacc
    return out


def to_jax(y):
    return {k: jnp.asarray(v) for k, v in y.items()}


@pytest.mark.parametrize("variant", ["basic", "basic_WB", "friction",
                                     "friction_angular"])
def test_rhs_matches_numpy_loop(variant):
    cfg = DEMConfig(variant=variant, n=12)
    state, _ = icond_dense(cfg, seed=3)
    # give the spheres motion and spin so every force term is exercised
    rng = np.random.RandomState(4)
    state["vel"] = rng.standard_normal((cfg.n, 3))
    if cfg.angular:
        state["angvel"] = 5.0 * rng.standard_normal((cfg.n, 3))
    # push two spheres into contact
    state["pos"][1] = state["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    rhs = make_dem_rhs(cfg)
    got = jax.tree_util.tree_map(np.asarray, rhs(0.0, to_jax(state)))
    want = numpy_dem_rhs(cfg, state)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                   atol=1e-12, err_msg=key)


class TestTwoSpheres:
    def test_head_on_repulsion_symmetry(self):
        # two equal spheres approaching along x: equal and opposite forces,
        # no tangential component, no torque
        cfg = DEMConfig(variant="friction_angular", n=2,
                        gravity=(0.0, 0.0, 0.0))
        y = {
            "pos": np.array([[0.4, 0.5, 0.5], [0.4 + 2 * cfg.r * 0.95, 0.5, 0.5]]),
            "vel": np.array([[1.0, 0, 0], [-1.0, 0, 0]]),
            "angvel": np.zeros((2, 3)),
        }
        out = make_dem_rhs(cfg)(0.0, to_jax(y))
        acc = np.asarray(out["vel"])
        np.testing.assert_allclose(acc[0], -acc[1], atol=1e-12)
        assert acc[0][0] < 0  # repelled
        np.testing.assert_allclose(acc[:, 1:], 0.0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(out["angvel"]), 0.0, atol=1e-9)

    def test_closed_form_normal_force(self):
        # static overlap: |acc| = CF(surf)*rebound(0) exactly
        cfg = DEMConfig(variant="basic", n=2, gravity=(0.0, 0.0, 0.0))
        gap = 0.9 * 2 * cfg.r
        y = {"pos": np.array([[0.5, 0.5, 0.5], [0.5 + gap, 0.5, 0.5]]),
             "vel": np.zeros((2, 3))}
        out = make_dem_rhs(cfg)(0.0, to_jax(y))
        dist = gap + cfg.zero
        surf = dist - 2 * cfg.r
        CF = cfg.collision_force_multiplier * np.exp(
            -cfg.collision_force_exponent * surf)
        reb = cfg.COR**2 + 0.5 * (1 - cfg.COR**2)  # tanh(0) -> midpoint
        # the +ZERO distance regularization leaves mp slightly sub-unit
        mp_x = gap / dist
        np.testing.assert_allclose(
            float(out["vel"][0][0]), -CF * reb * mp_x, rtol=1e-12)

    def test_spinning_sphere_on_floor_rolls(self):
        # a sphere spinning about y while resting on the floor must feel a
        # tangential force along x and a slowing torque about y
        cfg = DEMConfig(variant="friction_angular", n=1,
                        gravity=(0.0, 0.0, 0.0))
        y = {"pos": np.array([[0.5, 0.5, cfg.r * 0.98]]),
             "vel": np.zeros((1, 3)),
             "angvel": np.array([[0.0, 5.0, 0.0]])}
        out = make_dem_rhs(cfg)(0.0, to_jax(y))
        acc = np.asarray(out["vel"])[0]
        angacc = np.asarray(out["angvel"])[0]
        # omega_y > 0 spins the contact point toward +x -> friction pushes
        # the sphere toward -x? Surface velocity at contact = omega x r_c
        # with r_c = -r z_hat: (0,5,0)x(0,0,-r) = (-5r, 0, 0) -> contact
        # moves -x -> friction acts +x on the sphere.
        assert acc[0] > 0
        assert abs(acc[1]) < 1e-12
        assert angacc[1] < 0  # spin decays
        assert float(out["pos"][0][0]) == 0.0

    def test_wb_no_force_without_overlap(self):
        cfg = DEMConfig(variant="basic_WB", n=2, gravity=(0.0, 0.0, 0.0))
        y = {"pos": np.array([[0.5, 0.5, 0.5], [0.5 + 2.05 * cfg.r, 0.5, 0.5]]),
             "vel": np.zeros((2, 3))}
        out = make_dem_rhs(cfg)(0.0, to_jax(y))
        np.testing.assert_allclose(np.asarray(out["vel"]), 0.0, atol=1e-15)


class TestIntegration:
    def test_bounce_loses_energy(self):
        # drop one sphere on the floor: after a bounce the speed is reduced
        # by roughly COR (energy by COR^2) — the restitution model's purpose
        cfg = DEMConfig(variant="basic", n=1)
        y0 = {"pos": jnp.asarray([[0.5, 0.5, 0.5]]),
              "vel": jnp.asarray([[0.0, 0.0, 0.0]])}
        rhs = make_dem_rhs(cfg)
        state = merson_init(y0, 0.0, cfg.ht)
        params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
        # fall from 0.5-r=0.4m: impact speed ~2.8 m/s; integrate to after
        # first bounce
        state, status = merson_solve(rhs, state, 0.6, params)
        assert int(status) == 0
        z = float(state.y["pos"][0, 2])
        vz = float(state.y["vel"][0, 2])
        assert z > cfg.r * 0.5          # did not fall through the floor
        # apex after bounce is below drop height (energy dissipated)
        apex = z + max(vz, 0.0) ** 2 / (2 * 9.81)
        assert apex < 0.45

    def test_two_sphere_merson_run(self):
        cfg = DEMConfig(variant="friction_angular", n=2,
                        gravity=(0.0, 0.0, 0.0))
        y0, _ = icond_2spheres(cfg)
        rhs = make_dem_rhs(cfg)
        state = merson_init(to_jax(y0), 0.0, cfg.ht)
        state, status = merson_solve(
            rhs, state, 1.0, MersonParams(delta=cfg.delta, h_min=cfg.ht_min))
        assert int(status) == 0
        assert int(state.steps) > 0
        assert np.all(np.isfinite(np.asarray(state.y["pos"])))


class TestIconds:
    def test_dense_packing_inside_vessel(self):
        cfg = DEMConfig(variant="friction_angular", n=200)
        y, color = icond_dense(cfg, seed=0)
        assert y["pos"].shape == (200, 3)
        assert np.all(y["pos"][:, :2] >= 0) and np.all(y["pos"][:, :2] <= cfg.R)
        assert np.all(y["pos"][:, 2] >= cfg.h0)
        np.testing.assert_array_equal(color, y["pos"][:, 2])
        assert "angvel" in y

    def test_sparse_stacking(self):
        cfg = DEMConfig(variant="basic", n=10)
        y, _ = icond_sparse(cfg, seed=0)
        assert "angvel" not in y
        np.testing.assert_allclose(np.diff(y["pos"][:, 2]), 2 * cfg.r)

    def test_min_pair_distance_dense(self):
        cfg = DEMConfig(variant="basic", n=200)
        y, _ = icond_dense(cfg, seed=1)
        d = np.linalg.norm(
            y["pos"][:, None, :] - y["pos"][None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        # jittered grid spacing: 2.5r grid minus 0.25r jitter on each side
        assert d.min() > 2.5 * cfg.r - 0.5 * cfg.r


def test_device_buffer_matches_host_loop(tmp_path):
    """--device-buffer (lax.scan over snapshot targets, one dispatch per
    batch) must reproduce the per-snapshot host loop byte-for-byte —
    merson_solve's continuation-h contract threads through the scan
    carry exactly like through the host loop."""
    from porousfreezethaw.apps.spheres import main as spheres_main
    a = tmp_path / "host"
    b = tmp_path / "buffered"
    base = ["--variant", "friction_angular", "--n", "12",
            "--snapshots", "6", "--final-time", "0.3", "--seed", "5",
            "--platform", "cpu"]
    assert spheres_main(base + ["--output", str(a)]) == 0
    assert spheres_main(base + ["--output", str(b),
                                "--device-buffer", "4"]) == 0
    snaps = sorted(p.name for p in a.glob("snap_*.csv"))
    assert len(snaps) == 6
    for name in snaps:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
