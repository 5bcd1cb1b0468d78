"""Cell-list neighbor structure vs the masked-dense oracle.

The reference DEM is an O(n^2) cutoff scan (spheres_basic.c:222-286);
SURVEY §2.6 tasks this build with a scalable neighbor structure whose
results match the dense form exactly (same pairs found — only the
summation order over neighbors differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.models.dem import (
    DEMConfig, icond_dense, make_cell_list, make_dem_rhs)
from porousfreezethaw.solvers import MersonParams, merson_init, merson_solve


def settled_like_state(cfg, seed=0):
    """A dense random packing in the vessel (worst case for the cells)."""
    rng = np.random.RandomState(seed)
    n_side = int(np.ceil(cfg.n ** (1 / 3)))
    idx = np.arange(cfg.n)
    g = np.stack([idx % n_side, (idx // n_side) % n_side,
                  idx // n_side**2], axis=1)
    pos = 0.1 + g * 2.05 * cfg.r + 0.3 * cfg.r * rng.random_sample((cfg.n, 3))
    vel = 0.5 * rng.standard_normal((cfg.n, 3))
    y = {"pos": jnp.asarray(pos), "vel": jnp.asarray(vel)}
    if cfg.angular:
        y["angvel"] = jnp.asarray(rng.standard_normal((cfg.n, 3)))
    return y


@pytest.mark.parametrize("variant", ["basic", "friction_angular"])
def test_cell_list_matches_dense(variant):
    cfg = DEMConfig(variant=variant, n=100, r=0.1)
    y = settled_like_state(cfg)
    dense = make_dem_rhs(cfg, neighbor="dense")
    cells = make_dem_rhs(cfg, neighbor="cell_list")
    a = dense(0.0, y)
    b = cells(0.0, y)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-12, atol=1e-12)


def test_cell_list_finds_all_pairs_during_settle():
    """Short adaptive settle: dense and cell-list trajectories must track
    each other (same pairs -> same physics; only fp summation order
    differs, so allow a loose tolerance after many steps)."""
    cfg = DEMConfig(variant="friction_angular", n=27, r=0.1, T=0.5)
    y0, _ = icond_dense(cfg, seed=3)
    y0 = {k: jnp.asarray(v) for k, v in y0.items()}
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    out = {}
    for name in ("dense", "cell_list"):
        rhs = make_dem_rhs(cfg, neighbor=name)
        solve = jax.jit(lambda st, f=rhs: merson_solve(f, st, 0.5, params))
        st, status = solve(merson_init(y0, 0.0, cfg.ht))
        assert int(status) == 0
        out[name] = st
    np.testing.assert_allclose(np.asarray(out["dense"].y["pos"]),
                               np.asarray(out["cell_list"].y["pos"]),
                               rtol=1e-6, atol=1e-8)
    assert int(out["dense"].steps) == int(out["cell_list"].steps)


def test_occupancy_within_capacity():
    cfg = DEMConfig(n=200, r=0.1)
    nbr = make_cell_list(cfg)
    y = settled_like_state(cfg, seed=1)
    occ = nbr.cell_occupancy(y["pos"])
    assert occ <= nbr.capacity
    # sanity: the grid actually buckets into multiple cells
    assert occ < cfg.n


@pytest.mark.parametrize("n", [200, 2000, 20000])
def test_dense_icond_fits_cell_bounds(n):
    """The default cell bounds must contain the tallest initializer
    (icond_dense packs floor(R/2.5r)^2 per layer — round 4 found the
    old n^(1/3)-layer height model clipped large-n initial blocks into
    the top cell layer, overflowing capacity and silently dropping
    pairs)."""
    from porousfreezethaw.models.dem import make_cell_lanes
    r = 0.1 if n <= 400 else 0.1 * (200.0 / n) ** (1.0 / 3.0)
    cfg = DEMConfig(variant="friction_angular", n=n, r=r)
    y0, _ = icond_dense(cfg, seed=0)
    lanes = make_cell_lanes(cfg, capacity=16)
    assert lanes.cell_occupancy(y0["pos"]) <= lanes.capacity // 2


def test_large_n_smoke():
    """n=2000 cell-list evaluation is well-formed (the dense form would
    be 4M pairs; the cell list evaluates 2000 x 432 candidates)."""
    cfg = DEMConfig(variant="friction_angular", n=2000, r=0.03)
    rng = np.random.RandomState(0)
    pos = rng.random_sample((2000, 3)) * np.array([1.0, 1.0, 2.0])
    y = {"pos": jnp.asarray(pos),
         "vel": jnp.asarray(0.1 * rng.standard_normal((2000, 3))),
         "angvel": jnp.asarray(0.1 * rng.standard_normal((2000, 3)))}
    rhs = make_dem_rhs(cfg, neighbor="cell_list")
    out = rhs(0.0, y)
    assert np.isfinite(np.asarray(out["vel"])).all()
    # dense cross-check on a random subset is implicitly covered by the
    # n=100 equality test; here just assert gravity shows up
    assert np.asarray(out["pos"]).shape == (2000, 3)


@pytest.mark.parametrize("variant", ["basic", "friction_angular"])
def test_cell_roll_matches_dense(variant):
    """The cell-ROLL strategy (cell-major grid + 27 rolls, no
    gathers in the pair loop) finds the same pairs as the dense oracle."""
    cfg = DEMConfig(variant=variant, n=100, r=0.1)
    y = settled_like_state(cfg)
    dense = make_dem_rhs(cfg, neighbor="dense")
    rolls = make_dem_rhs(cfg, neighbor="cell_roll")
    a = dense(0.0, y)
    b = rolls(0.0, y)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-12, atol=1e-12)


def test_cell_roll_settle_tracks_dense():
    cfg = DEMConfig(variant="friction_angular", n=27, r=0.1, T=0.5)
    y0, _ = icond_dense(cfg, seed=3)
    y0 = {k: jnp.asarray(v) for k, v in y0.items()}
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    out = {}
    for name in ("dense", "cell_roll"):
        rhs = make_dem_rhs(cfg, neighbor=name)
        solve = jax.jit(lambda st, f=rhs: merson_solve(f, st, 0.5, params))
        st, status = solve(merson_init(y0, 0.0, cfg.ht))
        assert int(status) == 0
        out[name] = st
    np.testing.assert_allclose(np.asarray(out["dense"].y["pos"]),
                               np.asarray(out["cell_roll"].y["pos"]),
                               rtol=1e-6, atol=1e-8)
    assert int(out["dense"].steps) == int(out["cell_roll"].steps)


def test_cell_roll_large_n_smoke():
    cfg = DEMConfig(variant="friction_angular", n=2000, r=0.03)
    rng = np.random.RandomState(0)
    pos = rng.random_sample((2000, 3)) * np.array([1.0, 1.0, 2.0])
    y = {"pos": jnp.asarray(pos),
         "vel": jnp.asarray(0.1 * rng.standard_normal((2000, 3))),
         "angvel": jnp.asarray(0.1 * rng.standard_normal((2000, 3)))}
    rhs = make_dem_rhs(cfg, neighbor="cell_roll")
    out = jax.jit(lambda yy: rhs(0.0, yy))(y)
    assert np.isfinite(np.asarray(out["vel"])).all()


@pytest.mark.parametrize("variant", ["basic", "basic_WB", "friction",
                                     "friction_angular"])
def test_cell_lanes_matches_dense(variant):
    """The lane-major cell strategy (cells in lanes, capacity in
    sublanes, neighbors as flat-axis rolls — make_cell_lanes) finds the
    same pairs as the dense oracle in every force variant."""
    cfg = DEMConfig(variant=variant, n=100, r=0.1)
    y = settled_like_state(cfg)
    dense = make_dem_rhs(cfg, neighbor="dense")
    lanes = make_dem_rhs(cfg, neighbor="cell_lanes")
    a = dense(0.0, y)
    b = lanes(0.0, y)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-12, atol=1e-12)


def test_cell_lanes_settle_tracks_dense():
    cfg = DEMConfig(variant="friction_angular", n=27, r=0.1, T=0.5)
    y0, _ = icond_dense(cfg, seed=3)
    y0 = {k: jnp.asarray(v) for k, v in y0.items()}
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    out = {}
    for name in ("dense", "cell_lanes"):
        rhs = make_dem_rhs(cfg, neighbor=name)
        solve = jax.jit(lambda st, f=rhs: merson_solve(f, st, 0.5, params))
        st, status = solve(merson_init(y0, 0.0, cfg.ht))
        assert int(status) == 0
        out[name] = st
    np.testing.assert_allclose(np.asarray(out["dense"].y["pos"]),
                               np.asarray(out["cell_lanes"].y["pos"]),
                               rtol=1e-6, atol=1e-8)
    # the two strategies sum pair forces in different orders, so an
    # accept decision riding a tolerance boundary may flip by one step
    assert abs(int(out["dense"].steps)
               - int(out["cell_lanes"].steps)) <= 1


def test_cell_lanes_large_n_smoke():
    cfg = DEMConfig(variant="friction_angular", n=2000, r=0.03)
    rng = np.random.RandomState(0)
    pos = rng.random_sample((2000, 3)) * np.array([1.0, 1.0, 2.0])
    y = {"pos": jnp.asarray(pos),
         "vel": jnp.asarray(0.1 * rng.standard_normal((2000, 3))),
         "angvel": jnp.asarray(0.1 * rng.standard_normal((2000, 3)))}
    rhs = make_dem_rhs(cfg, neighbor="cell_lanes")
    out = jax.jit(lambda yy: rhs(0.0, yy))(y)
    assert np.isfinite(np.asarray(out["vel"])).all()
    assert np.asarray(out["pos"]).shape == (2000, 3)


def test_cell_lanes_overflow_poisons():
    """Guarded capacity (round 5): a cell holding more than K particles
    must NOT silently drop pairs — the kernel poisons its output with
    NaN and cell_occupancy reports the overflow so drivers can abort
    with a clear message (bench.py / apps/spheres.py check it at every
    chunk boundary)."""
    cfg = DEMConfig(variant="friction_angular", n=12, r=0.1)
    rng = np.random.RandomState(0)
    # all 12 particles jittered inside one cell (edge = 2r + cutoff)
    pos = 0.15 + 0.01 * rng.random_sample((12, 3))
    y = {"pos": jnp.asarray(pos),
         "vel": jnp.asarray(rng.standard_normal((12, 3))),
         "angvel": jnp.asarray(rng.standard_normal((12, 3)))}
    rhs = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=8)
    assert rhs.neighbor_struct.cell_occupancy(y["pos"]) > 8
    out = rhs(0.0, y)
    assert np.isnan(np.asarray(out["vel"])).all()
    assert np.isnan(np.asarray(out["angvel"])).all()
    # the same configuration under an adequate capacity is clean and
    # matches the dense oracle
    ok = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=16)
    dense = make_dem_rhs(cfg, neighbor="dense")
    a, b = ok(0.0, y), dense(0.0, y)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-12, atol=1e-12)
