"""Freezing RHS tests: the jnp stencil vs an independent NumPy
ghost-cell implementation of equation.c's f_generic_model01/f_generic_model2."""

import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.models.freezing import (
    CalcMode, FreezingParams, make_rhs)
from porousfreezethaw.models.freezing.parameters import PARAM_NAMES


def default_params(**over):
    """Parameter values from the shipped Params file (Params:44-122)."""
    hours = 3600.0
    L1 = L2 = 0.03
    L3 = 0.06
    wall_thickness = 0.05
    beads_scaling = (1 - 2 * wall_thickness) * L1
    vals = dict(
        u_star=273.15, L=3.34e5, xi=L3 / 100, a=2.0, b=1.0,
        alpha=997 * 4.18e3, mu=1e-4,
        beads_scaling=beads_scaling,
        beads_offset_x=wall_thickness * L1,
        beads_offset_y=wall_thickness * L1,
        beads_offset_z=wall_thickness * L1,
        xi_gl=L3 / 500, zeta=1.05,
        p_eps0=0.05, p_eps1=0.2, gamma=2.0,
        water_cp=4.18e3, ice_cp=2.05e3, glass_cp=0.84e3,
        water_lambda=0.6, ice_lambda=2.22, glass_lambda=1.1,
        water_rho=997.0, ice_rho=917.0, glass_rho=2500.0,
        top_temp1=273.15 - 25, top_temp2=273.15 + 20,
        phase_switch_time=5 * hours, u_noise_amp=0.0,
        ball_radius=0.1 * beads_scaling,
    )
    vals.update(over)
    return FreezingParams(**vals)


def pad_mirror(f):
    """FVM mirror ghost layer: first phantom node = adjacent interior node."""
    return np.pad(f, 1, mode="edge")


def numpy_rhs(geom, prm, calc_mode, t, w):
    """Independent ghost-cell implementation of the reference stencil
    (equation.c:566-884), written against the equations, not the loops."""
    u, p, gl = (np.asarray(f, dtype=np.float64) for f in w)
    h1, h2, h3 = geom.inv_h
    h1_2, h2_2, h3_2 = h1 * h1, h2 * h2, h3 * h3

    def rho(p_, gl_):
        return gl_ * prm.glass_rho + (1 - gl_) * (p_ * prm.ice_rho + (1 - p_) * prm.water_rho)

    def cp(p_, gl_):
        return gl_ * prm.glass_cp + (1 - gl_) * (p_ * prm.ice_cp + (1 - p_) * prm.water_cp)

    def lam(p_, gl_):
        return gl_ * prm.glass_lambda + (1 - gl_) * (p_ * prm.ice_lambda + (1 - p_) * prm.water_lambda)

    def wind(gl_):
        return np.maximum(0.0, 1.0 - prm.zeta * gl_)

    U, P, GL = pad_mirror(u), pad_mirror(p), pad_mirror(gl)
    # Dirichlet top BC on u: z-top ghost plane = top temperature
    top = prm.top_temp1 if t < prm.phase_switch_time else prm.top_temp2
    U[-1, :, :] = top

    C = np.s_[1:-1, 1:-1, 1:-1]
    xm = np.s_[1:-1, 1:-1, :-2]; xp = np.s_[1:-1, 1:-1, 2:]
    ym = np.s_[1:-1, :-2, 1:-1]; yp = np.s_[1:-1, 2:, 1:-1]
    zm = np.s_[:-2, 1:-1, 1:-1]; zp = np.s_[2:, 1:-1, 1:-1]

    def lap(F):
        return (h1_2 * (F[xm] + F[xp] - 2 * F[C])
                + h2_2 * (F[ym] + F[yp] - 2 * F[C])
                + h3_2 * (F[zm] + F[zp] - 2 * F[C]))

    def div_lam_grad_u():
        out = np.zeros_like(u)
        for lo, hi, w2 in ((xm, xp, h1_2), (ym, yp, h2_2), (zm, zp, h3_2)):
            out += w2 * (
                lam(0.5 * (P[lo] + P[C]), 0.5 * (GL[lo] + GL[C])) * (U[lo] - U[C])
                + lam(0.5 * (P[hi] + P[C]), 0.5 * (GL[hi] + GL[C])) * (U[hi] - U[C]))
        return out

    if calc_mode == 2:
        aux = np.cosh(prm.gamma * (u - prm.u_star))
        dp_du = (-0.5 * prm.gamma / (aux * aux)) * wind(gl)
        du_dt = div_lam_grad_u() / (rho(p, gl) * (cp(p, gl) - prm.L * dp_du))
        dp_dt = dp_du * du_dt
    else:
        dp_dt = lap(P)
        xi2a = prm.a / prm.xi**2
        if calc_mode in (0, 10):
            gn = np.sqrt(
                (0.5 * h1 * (P[xp] - P[xm]))**2
                + (0.5 * h2 * (P[yp] - P[ym]))**2
                + (0.5 * h3 * (P[zp] - P[zm]))**2) + 1e-10
            dp_dt += (xi2a * p * (1 - p) * (p - 0.5)
                      - prm.b * prm.alpha * prm.mu * gn * (u - prm.u_star))
        else:
            d = prm.p_eps1 - prm.p_eps0
            e23, e32 = 3 / d**2, 2 / d**3

            def S(x):
                xs = x - prm.p_eps0
                return np.where(x <= prm.p_eps0, 0.0,
                                np.where(x >= prm.p_eps1, 1.0,
                                         xs * xs * (e23 - e32 * xs)))
            xiba = prm.b * np.sqrt(0.5 * prm.a) / prm.xi
            dp_dt += (xi2a * p * (1 - p) * (p - 0.5)
                      - xiba * prm.alpha * prm.mu * S(p) * S(1 - p)
                      * np.maximum(p * (1 - p), 0.0) * (u - prm.u_star))
        dp_dt = dp_dt / prm.alpha * wind(gl)
        if calc_mode in (10, 11):
            du_dt = np.zeros_like(u)
        else:
            du_dt = (div_lam_grad_u() / rho(p, gl) + prm.L * dp_dt) / cp(p, gl)

    return np.stack([du_dt, dp_dt, np.zeros_like(gl)])


@pytest.fixture(scope="module")
def setup():
    geom = GridGeometry(L1=0.03, L2=0.03, L3=0.06, n1=8, n2=10, n3=16)
    prm = default_params()
    rng = np.random.RandomState(7)
    u = 273.15 + 30 * (rng.random_sample(geom.shape) - 0.5)
    p = np.clip(rng.random_sample(geom.shape), 0, 1)
    gl = np.clip(rng.random_sample(geom.shape) * 1.2 - 0.2, 0, 1)
    w = np.stack([u, p, gl])
    return geom, prm, w


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_rhs_matches_numpy(setup, mode):
    geom, prm, w = setup
    rhs = make_rhs(geom, prm, mode)
    got = np.asarray(rhs(100.0, jnp.asarray(w)))
    want = numpy_rhs(geom, prm, mode, 100.0, w)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)


def test_dirichlet_switch(setup):
    # top boundary switches from top_temp1 to top_temp2 at phase_switch_time
    geom, prm, w = setup
    rhs = make_rhs(geom, prm, 0)
    before = np.asarray(rhs(prm.phase_switch_time - 1.0, jnp.asarray(w)))
    after = np.asarray(rhs(prm.phase_switch_time + 1.0, jnp.asarray(w)))
    # only the top z-plane of du/dt should differ
    assert not np.allclose(before[0][-1], after[0][-1])
    np.testing.assert_array_equal(before[0][:-1], after[0][:-1])
    np.testing.assert_array_equal(before[1], after[1])


def test_frozen_temperature_modes(setup):
    geom, prm, w = setup
    for frozen, live in ((10, 0), (11, 1)):
        r_frozen = np.asarray(make_rhs(geom, prm, frozen)(0.0, jnp.asarray(w)))
        r_live = np.asarray(make_rhs(geom, prm, live)(0.0, jnp.asarray(w)))
        assert np.all(r_frozen[0] == 0.0)            # du/dt = 0
        np.testing.assert_allclose(r_frozen[1], r_live[1], rtol=1e-12)


def test_glass_field_frozen(setup):
    # dgl/dt is identically zero; p does not evolve deep inside glass
    geom, prm, w = setup
    w = w.copy()
    w[2] = 1.0  # all glass
    out = np.asarray(make_rhs(geom, prm, 0)(0.0, jnp.asarray(w)))
    assert np.all(out[2] == 0.0)
    np.testing.assert_array_equal(out[1], 0.0)  # water_indicator(1)=max(0,1-1.05)=0


def test_uniform_state_zero_laplacian():
    # uniform u away from the Dirichlet top must give zero du/dt for mode 2
    geom = GridGeometry(0.03, 0.03, 0.06, 6, 6, 12)
    prm = default_params()
    w = np.stack([np.full(geom.shape, 250.0), np.zeros(geom.shape),
                  np.zeros(geom.shape)])
    out = np.asarray(make_rhs(geom, prm, 2)(0.0, jnp.asarray(w)))
    # interior (all but top z-plane) exactly zero flux
    np.testing.assert_allclose(out[0][:-1], 0.0, atol=1e-18)
    # top plane feels the Dirichlet boundary (u=248.15 < 250)
    assert np.all(out[0][-1] < 0.0)


def test_noise_only_in_reaction(setup):
    geom, prm, w = setup
    noise = np.full(geom.shape, 0.5)
    rhs_n = make_rhs(geom, prm, 0, noise=jnp.asarray(noise))
    rhs_0 = make_rhs(geom, prm, 0)
    out_n = np.asarray(rhs_n(0.0, jnp.asarray(w)))
    out_0 = np.asarray(rhs_0(0.0, jnp.asarray(w)))
    # the GradP reaction term feels the noise...
    assert not np.allclose(out_n[1], out_0[1])
    # ...which propagates to du/dt only through the L*dp_dt coupling:
    prm_noL = default_params(L=0.0)
    out_n2 = np.asarray(make_rhs(geom, prm_noL, 0, noise=jnp.asarray(noise))(0.0, jnp.asarray(w)))
    out_02 = np.asarray(make_rhs(geom, prm_noL, 0)(0.0, jnp.asarray(w)))
    np.testing.assert_allclose(out_n2[0], out_02[0], rtol=1e-12)
