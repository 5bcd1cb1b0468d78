"""The increment-form attempt on GSPMD meshes of the 8-virtual-device
CPU backend, against one device: a sharded raw state must give the same
speculative state and error max (SURVEY §4.2 rank-count invariance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
from porousfreezethaw.parallel.sharding import (
    freezing_sharding, make_mesh, shard_freezing_state)

from tests.test_sharded_xla import MESHES, MODES, make_case


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", MESHES)
def test_delta_attempt_sharded_equals_single(spec, mode, dtype):
    dt = jnp.float32 if dtype == "f32" else jnp.float64
    geom, prm, w = make_case(dt)
    att = XlaDeltaAttempt(geom, prm, mode)
    t = jnp.asarray(100.0, jnp.float64)
    h = jnp.asarray(0.05, jnp.float64)
    step = jax.jit(lambda y: att.attempt(t, h, y))
    (_, spec_1), eps_1 = step(w)

    mesh = make_mesh(spec)
    (_, spec_n), eps_n = step(shard_freezing_state(w, mesh))
    assert spec_n.sharding.is_equivalent_to(freezing_sharding(mesh), ndim=4)
    # elementwise work is identical per cell; only fusion boundaries
    # (and with them FMA contraction) may differ between the programs
    tol = 1e-6 if dtype == "f32" else 1e-13
    scale = np.abs(np.asarray(spec_1)).max(axis=(1, 2, 3), keepdims=True)
    np.testing.assert_allclose(np.asarray(spec_n) / scale,
                               np.asarray(spec_1) / scale, rtol=0, atol=tol)
    # the estimate is a difference of G's, so their rounding is amplified
    # by |G| / |estimate| (up to ~1e2 in f32 on this rough state)
    eps_tol = 2e-3 if dtype == "f32" else 1e-11
    np.testing.assert_allclose(float(jnp.max(eps_n)), float(jnp.max(eps_1)),
                               rtol=eps_tol)
