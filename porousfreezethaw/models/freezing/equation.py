"""Right-hand side of the freezing/thawing PDE system.

A re-design of the reference stencil kernels
``f_generic_model01`` / ``f_generic_model2``
(``apps/intertrack-hybrid-S-freezing/equation.c:566-884``) and their
boundary-condition setup (``equation.c:96-284``).

The reference mutates ghost layers in-place (mirror Neumann everywhere,
Dirichlet at the z-top for the temperature), exchanges MPI halos inside
every RK stage, then sweeps a 7-point finite-volume stencil with OpenMP.
Here the state ``w`` holds only the inner cells, shaped
``(3, n3, n2, n1)`` = (variables, z, y, x), and neighbor access is a pure
function: ``jnp.roll`` along the axis (a collective-permute when the axis
is sharded over the device mesh — the halo exchange) followed by a
boundary fix-up with ``jnp.where`` (the BC "mirror"), letting XLA fuse the
whole stencil into a single pass over HBM.

Models (selected by ``calc_mode``, equation.c:536-555, Params:115-122):

* 0 / 10 — Allen-Cahn phase field with GradP reaction coupling
  (+ heat equation; 10 = temperature frozen in time)
* 1 / 11 — phase field with SigmaP1-P reaction term (S-shape limited)
* 2 — heat equation only, with the algebraic phase field ``p = phf(u)``
  and latent-heat focusing in the denominator (equation.c:850-867)
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ...core.grid import GridGeometry
from . import physics
from .parameters import FreezingParams
from .physics import EPS_REGULARIZATION


class CalcMode(enum.IntEnum):
    GRADP = 0
    SIGMAP = 1
    TEMP = 2
    GRADP_FROZEN_U = 10
    SIGMAP_FROZEN_U = 11


# axis indices inside one field array (z, y, x)
_Z, _Y, _X = 0, 1, 2


def _neighbor(f: jax.Array, axis: int, direction: int,
              boundary: Optional[jax.Array] = None) -> jax.Array:
    """Value of the neighbor cell in +-1 ``direction`` along ``axis``.

    Outside the domain the FVM mirror rule gives the adjacent interior value
    (first phantom node == nearest cell, equation.c:187-199), i.e. the
    boundary plane keeps its own value; a Dirichlet ``boundary`` (scalar or
    plane) overrides that at the far end (equation.c:113-185).

    ``jnp.roll`` on a mesh-sharded axis lowers to a collective permute —
    this is the framework's halo exchange.
    """
    n = f.shape[axis]
    shifted = jnp.roll(f, -direction, axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, f.shape, axis)
    edge = idx == (n - 1 if direction > 0 else 0)
    fill = f if boundary is None else jnp.broadcast_to(boundary, f.shape)
    return jnp.where(edge, fill, shifted)


def make_rhs(geom: GridGeometry, params: FreezingParams, calc_mode: int,
             noise: Optional[jax.Array] = None):
    """Build ``rhs(t, w) -> dw/dt`` for state ``w`` of shape (3, n3, n2, n1).

    ``noise`` is the precomputed per-cell temperature noise field
    (PRECALC_DATA.u_noise, equation.c:449-456); None means no noise (the
    shipped Params uses u_noise_amp = 0).
    """
    mode = CalcMode(calc_mode)
    p_ = params
    coeffs = physics.Coeffs.of(p_)

    inv_h1, inv_h2, inv_h3 = geom.inv_h
    h1_2, h2_2, h3_2 = inv_h1**2, inv_h2**2, inv_h3**2
    h1d2, h2d2, h3d2 = 0.5 * inv_h1, 0.5 * inv_h2, 0.5 * inv_h3

    # cell-local physics shared with the increment form (physics.py)
    rho = lambda p, gl: physics.rho(p, gl, p_)
    cp = lambda p, gl: physics.cp(p, gl, p_)
    lam = lambda p, gl: physics.lam(p, gl, p_)
    water_indicator = lambda gl: physics.water_indicator(gl, p_)
    f_gradp = lambda u, p, gn: physics.f_gradp(u, p, gn, p_, coeffs)
    f_sigmap1_p = lambda u, p: physics.f_sigmap1_p(u, p, p_, coeffs)
    dphf_du = lambda u: physics.dphf_du(u, p_)
    dirichlet_top = lambda t: physics.dirichlet_top(t, p_)

    def laplacian(f):
        """div(grad f) on the FVM grid with mirror BCs (zero flux)."""
        out = h1_2 * (_neighbor(f, _X, -1) + _neighbor(f, _X, +1) - 2.0 * f)
        out += h2_2 * (_neighbor(f, _Y, -1) + _neighbor(f, _Y, +1) - 2.0 * f)
        out += h3_2 * (_neighbor(f, _Z, -1) + _neighbor(f, _Z, +1) - 2.0 * f)
        return out

    def div_lambda_grad_u(u, p, gl, t):
        """div(lambda grad u); face conductivity = lambda(arithmetic mean of
        p, gl at the face) (equation.c:711-723); Dirichlet top BC on u."""
        top = dirichlet_top(t)

        def flux(axis, direction, u_b=None):
            un = _neighbor(u, axis, direction, u_b)
            pn = _neighbor(p, axis, direction)
            gln = _neighbor(gl, axis, direction)
            return lam(0.5 * (p + pn), 0.5 * (gl + gln)) * (un - u)

        out = h1_2 * (flux(_X, -1) + flux(_X, +1))
        out += h2_2 * (flux(_Y, -1) + flux(_Y, +1))
        out += h3_2 * (flux(_Z, -1) + flux(_Z, +1, top))
        return out

    def rhs(t, w):
        u, p, gl = w[0], w[1], w[2]
        dtype = w.dtype
        t = jnp.asarray(t, dtype)
        u_noisy = u if noise is None else u + noise.astype(dtype)

        if mode in (CalcMode.TEMP,):
            # --- model 2 (equation.c:745-884) ---
            dp_du = dphf_du(u) * water_indicator(gl)
            denom = rho(p, gl) * (cp(p, gl) - p_.L * dp_du)
            du_dt = div_lambda_grad_u(u, p, gl, t) / denom
            dp_dt = dp_du * du_dt
        else:
            # --- models 0/1 (+frozen-u 10/11) (equation.c:566-741) ---
            dp_dt = laplacian(p)
            if mode in (CalcMode.GRADP, CalcMode.GRADP_FROZEN_U):
                gradp_norm = jnp.sqrt(
                    (h1d2 * (_neighbor(p, _X, +1) - _neighbor(p, _X, -1))) ** 2
                    + (h2d2 * (_neighbor(p, _Y, +1) - _neighbor(p, _Y, -1))) ** 2
                    + (h3d2 * (_neighbor(p, _Z, +1) - _neighbor(p, _Z, -1))) ** 2
                ) + EPS_REGULARIZATION
                dp_dt += f_gradp(u_noisy, p, gradp_norm)
            else:
                dp_dt += f_sigmap1_p(u_noisy, p)
            dp_dt = dp_dt / p_.alpha * water_indicator(gl)

            if mode in (CalcMode.GRADP_FROZEN_U, CalcMode.SIGMAP_FROZEN_U):
                du_dt = jnp.zeros_like(u)
            else:
                du_dt = (div_lambda_grad_u(u, p, gl, t) / rho(p, gl)
                         + p_.L * dp_dt) / cp(p, gl)

        dgl_dt = jnp.zeros_like(gl)  # glass balls are static (equation.c:727-731)
        return jnp.stack([du_dt, dp_dt, dgl_dt])

    return rhs


def make_noise_field(geom: GridGeometry, params: FreezingParams, key,
                     dtype=jnp.float64) -> Optional[jax.Array]:
    """Per-cell temperature noise  u_noise_amp * (U(0,1) - 0.5)
    (equation.c:449-456).  The reference uses per-rank libc rand(); the
    framework uses the JAX threefry PRNG — documented deviation; the
    shipped benchmark Params sets u_noise_amp = 0, where both agree
    exactly."""
    if params.u_noise_amp == 0.0:
        return None
    uni = jax.random.uniform(key, geom.shape, dtype=dtype)
    return params.u_noise_amp * (uni - 0.5)
