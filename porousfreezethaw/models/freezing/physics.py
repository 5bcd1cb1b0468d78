"""Cell-local physics of the freezing model, shared by the classic stencil
(equation.py) and the increment form (delta.py).

All functions are pure elementwise jnp math over arrays of any shape;
formulas follow equation.c:341-421 and the precalculated auxiliaries
equation.c:439-447.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .parameters import FreezingParams

EPS_REGULARIZATION = 1e-10  # equation.c:330


@dataclasses.dataclass(frozen=True)
class Coeffs:
    """Precomputed scalar coefficients (PrecalculateData, equation.c:439-447)."""

    xi_2_inv_a: float
    xi_inv_b_sqrt_a2: float
    eps2_3: float
    eps3_2: float

    @staticmethod
    def of(p: FreezingParams) -> "Coeffs":
        d = p.p_eps1 - p.p_eps0
        return Coeffs(
            xi_2_inv_a=p.a / (p.xi * p.xi),
            xi_inv_b_sqrt_a2=p.b * (0.5 * p.a) ** 0.5 / p.xi,
            eps2_3=3.0 / (d * d),
            eps3_2=2.0 / (d * d * d),
        )


def rho(p_, gl, prm: FreezingParams):
    return gl * prm.glass_rho + (1.0 - gl) * (
        p_ * prm.ice_rho + (1.0 - p_) * prm.water_rho)


def cp(p_, gl, prm: FreezingParams):
    return gl * prm.glass_cp + (1.0 - gl) * (
        p_ * prm.ice_cp + (1.0 - p_) * prm.water_cp)


def lam(p_, gl, prm: FreezingParams):
    return gl * prm.glass_lambda + (1.0 - gl) * (
        p_ * prm.ice_lambda + (1.0 - p_) * prm.water_lambda)


def water_indicator(gl, prm: FreezingParams):
    expr = 1.0 - prm.zeta * gl
    return jnp.maximum(jnp.zeros_like(expr), expr)


def sshape(x, prm: FreezingParams, c: Coeffs):
    xs = x - prm.p_eps0
    mid = xs * xs * (c.eps2_3 - c.eps3_2 * xs)
    return jnp.where(x <= prm.p_eps0, jnp.zeros_like(mid),
                     jnp.where(x >= prm.p_eps1, jnp.ones_like(mid), mid))


def f_gradp(u, p_, gradp_norm, prm: FreezingParams, c: Coeffs):
    return (c.xi_2_inv_a * p_ * (1.0 - p_) * (p_ - 0.5)
            - prm.b * prm.alpha * prm.mu * gradp_norm * (u - prm.u_star))


def f_sigmap1_p(u, p_, prm: FreezingParams, c: Coeffs):
    pq = p_ * (1.0 - p_)
    return (c.xi_2_inv_a * p_ * (1.0 - p_) * (p_ - 0.5)
            - c.xi_inv_b_sqrt_a2 * prm.alpha * prm.mu
            * sshape(p_, prm, c) * sshape(1.0 - p_, prm, c)
            * jnp.maximum(pq, jnp.zeros_like(pq)) * (u - prm.u_star))


def dphf_du(u, prm: FreezingParams):
    # -gamma/2 * sech^2(gamma (u - u*)), with sech written in exps as
    # 2 e^{-|x|} / (1 + e^{-2|x|}): overflow-free at any |x|
    x = jnp.abs(prm.gamma * (u - prm.u_star))
    e = jnp.exp(-x)
    sech = 2.0 * e / (1.0 + e * e)
    return -0.5 * prm.gamma * (sech * sech)


def dirichlet_top(t, prm: FreezingParams):
    # branch values follow t's dtype
    dt = jnp.result_type(t)
    return jnp.where(t < prm.phase_switch_time,
                     jnp.asarray(prm.top_temp1, dt),
                     jnp.asarray(prm.top_temp2, dt))
