"""Increment-form (delta) RHS: exactness vs the direct evaluation and
the f32 error-estimator noise-floor elimination it exists for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.models.freezing import make_rhs
from porousfreezethaw.models.freezing.delta import make_g_rhs

from tests.test_freezing_equation import default_params

MODES = [0, 1, 2, 10, 11]


@pytest.fixture(scope="module")
def case():
    geom = GridGeometry(0.03, 0.03, 0.06, 12, 10, 14)
    prm = default_params()
    rng = np.random.RandomState(7)
    w = np.stack([
        273.15 + 10 * (rng.random_sample(geom.shape) - 0.5),
        rng.random_sample(geom.shape),
        rng.random_sample(geom.shape) * 0.6])
    K = rng.standard_normal((2,) + geom.shape)
    return geom, prm, w, K


@pytest.mark.parametrize("mode", MODES)
def test_g_matches_direct_difference_f64(case, mode):
    """G(t1, ti, w, d) == f(ti, w+d) - f(t1, w) as an identity (f64)."""
    geom, prm, w, K = case
    rhs = make_rhs(geom, prm, calc_mode=mode)
    g = make_g_rhs(geom, prm, calc_mode=mode)
    w64 = jnp.asarray(w, jnp.float64)
    for h in (1e-3, 1e-1, 10.0):
        d = jnp.asarray(h * K, jnp.float64)
        t1, ti = 100.0, 100.0 + h
        wd = w64.at[:2].add(d)
        direct = (rhs(ti, wd) - rhs(t1, w64))[:2]
        G = g(t1, ti, w64, d)
        scale = np.maximum(np.abs(np.asarray(direct)), 1e-3)
        np.testing.assert_allclose(np.asarray(G) / scale,
                                   np.asarray(direct) / scale,
                                   atol=1e-9)


def test_g_dirichlet_switch_step(case):
    """A step crossing phase_switch_time sees different Dirichlet values
    per stage; the delta ghost D(ti)-D(t1) keeps G exact."""
    geom, prm, w, K = case
    rhs = make_rhs(geom, prm, calc_mode=0)
    g = make_g_rhs(geom, prm, calc_mode=0)
    w64 = jnp.asarray(w, jnp.float64)
    d = jnp.asarray(1e-2 * K, jnp.float64)
    t1 = prm.phase_switch_time - 1.0
    ti = prm.phase_switch_time + 1.0  # crosses the switch
    wd = w64.at[:2].add(d)
    direct = (rhs(ti, wd) - rhs(t1, w64))[:2]
    G = g(t1, ti, w64, d)
    scale = np.maximum(np.abs(np.asarray(direct)), 1e-3)
    np.testing.assert_allclose(np.asarray(G) / scale,
                               np.asarray(direct) / scale, atol=1e-9)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_f32_estimator_floor_removed(case, mode):
    """The Merson error combination computed from f32 G's tracks the f64
    truth far better than the classic f32 stage evaluation: the classic
    path's stage-state rounding floor (~ulp(w)*|J|) is absent.

    Builds K1/K3/K4/K5 via the actual stage algebra at a small h where
    the true estimate is tiny, then compares |est_f32 - est_f64|."""
    geom, prm, w, _ = case
    h = 1e-6  # true estimate ~h^4-scale: rounding floors dominate
    t = 100.0

    def estimate(dtype, use_delta):
        w_ = jnp.asarray(w, dtype)
        rhs = make_rhs(geom, prm, calc_mode=mode)
        if not use_delta:
            K1 = rhs(t, w_)[:2]
            y2 = w_.at[:2].add(jnp.asarray(h / 3, dtype) * K1)
            K2 = rhs(t + h / 3, y2)[:2]
            y3 = w_.at[:2].add(jnp.asarray(h / 6, dtype) * (K1 + K2))
            K3 = rhs(t + h / 3, y3)[:2]
            y4 = w_.at[:2].add(jnp.asarray(h / 8, dtype) * (K1 + 3 * K3))
            K4 = rhs(t + h / 2, y4)[:2]
            y5 = w_.at[:2].add(jnp.asarray(h, dtype)
                               * (0.5 * K1 - 1.5 * K3 + 2 * K4))
            K5 = rhs(t + h, y5)[:2]
            return 0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5
        g = make_g_rhs(geom, prm, calc_mode=mode)
        rhs_ = make_rhs(geom, prm, calc_mode=mode)
        hh = jnp.asarray(h, dtype)
        K1 = rhs_(t, w_)[:2]
        G2 = g(t, t + h / 3, w_, hh / 3 * K1)
        G3 = g(t, t + h / 3, w_, hh * (K1 / 3 + G2 / 6))
        G4 = g(t, t + h / 2, w_, hh * (K1 / 2 + 0.375 * G3))
        G5 = g(t, t + h, w_, hh * (K1 - 1.5 * G3 + 2 * G4))
        return -0.9 * G3 + 0.8 * G4 - 0.1 * G5

    ref = np.asarray(estimate(jnp.float64, False))
    err_classic = np.max(np.abs(np.asarray(
        estimate(jnp.float32, False)).astype(np.float64) - ref))
    err_delta = np.max(np.abs(np.asarray(
        estimate(jnp.float32, True)).astype(np.float64) - ref))
    # the classic path floors at ulp(w)*|J|; measured improvement:
    # GradP 3.2e6x, SigmaP 1.6e6x, Temp 29x (its classic floor is
    # already tiny — the model is not noise-pinned in practice)
    factor = {0: 1e4, 1: 1e4, 2: 10.0}[mode]
    assert err_delta < err_classic / factor, (err_delta, err_classic)


def _classic_attempt(rhs, t, h, w):
    """One classic Merson attempt (solvers/merson.py stage algebra):
    the speculative (u, p) update and the error max."""
    K1 = rhs(t, w)
    K2 = rhs(t + h / 3, w + (h / 3) * K1)
    K3 = rhs(t + h / 3, w + (h / 6) * (K1 + K2))
    K4 = rhs(t + h / 2, w + (h / 8) * (K1 + 3 * K3))
    K5 = rhs(t + h, w + h * (0.5 * K1 - 1.5 * K3 + 2 * K4))
    eps = jnp.max(jnp.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5)[:2])
    y = w + (h / 3) * (0.5 * (K1 + K5) + 2 * K4)
    return y[:2], eps


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
def test_xla_delta_attempt_matches_classic_f64(case, mode, dtype):
    """One XlaDeltaAttempt (the app's f32 production attempt) against the
    classic f64 Merson attempt at the same h: same speculative state and
    error max.  f64 agrees to rounding; f32 to its state quantization
    (|w| ~ 300 K at ulp 3e-5) — the estimator itself carries no floor."""
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    geom, prm, w, _ = case
    t, h = 100.0, 0.05
    want_y, want_eps = _classic_attempt(
        make_rhs(geom, prm, calc_mode=mode), t, h, jnp.asarray(w))
    want_y, want_eps = np.asarray(want_y), float(want_eps)

    dt = jnp.float32 if dtype == "f32" else jnp.float64
    att = XlaDeltaAttempt(geom, prm, mode)
    y = jnp.asarray(w, dt)
    (_, spec), eps = att.attempt(jnp.asarray(t, jnp.float64),
                                 jnp.asarray(h, jnp.float64), y)
    got_eps = float(jnp.max(eps))
    scale = np.abs(want_y).max(axis=(1, 2, 3), keepdims=True)
    tol = 1e-6 if dtype == "f32" else 1e-12
    np.testing.assert_allclose(np.asarray(spec, np.float64) / scale,
                               want_y / scale, rtol=0, atol=tol)
    eps_tol = 2e-3 if dtype == "f32" else 1e-8
    assert abs(got_eps - want_eps) <= eps_tol * want_eps + 1e-9, (
        got_eps, want_eps)

    kept = att.commit((y, spec), jnp.asarray(False))
    np.testing.assert_array_equal(np.asarray(kept), np.asarray(y))
    taken = att.commit((y, spec), jnp.asarray(True))
    np.testing.assert_array_equal(np.asarray(taken[:2]), np.asarray(spec))
    np.testing.assert_array_equal(np.asarray(taken[2]), np.asarray(y[2]))


def test_delta_solve_tracks_f64(case):
    """merson_solve over XlaDeltaAttempt in f32 tracks the f64 classic
    trajectory and step counts on the stiff GradP model."""
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)
    geom, prm, w, _ = case
    params = MersonParams(delta=1e-3, h_min=1e-9, max_steps=200)

    st64, status64 = merson_solve(
        make_rhs(geom, prm, calc_mode=0),
        merson_init(jnp.asarray(w, jnp.float64), 0.0, 1e-4),
        0.05, params)
    assert int(status64) == 0

    att = XlaDeltaAttempt(geom, prm, 0)
    st32, status32 = merson_solve(
        None, merson_init(jnp.asarray(w, jnp.float32), 0.0, 1e-4), 0.05,
        params, attempt_fn=att)
    assert int(status32) == 0
    # step counts within a few of the f64 truth (no noise floor)
    assert abs(int(st32.steps) - int(st64.steps)) <= max(
        3, int(0.1 * int(st64.steps)))
    y32 = np.asarray(st32.y)
    y64 = np.asarray(st64.y)
    scale = np.abs(y64[:2]).max()
    assert np.abs(y32[:2] - y64[:2]).max() / scale < 1e-4
