"""The production attempts on GSPMD meshes of the 8-virtual-device CPU
backend: a sharded raw ``(3, n3, n2, n1)`` state must give the results of
one device (the reference's rank-count-invariance oracle, SURVEY §4.2).
Rolls along a sharded axis become collective permutes; the error max
becomes an all-reduce."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.models.freezing import make_rhs
from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
from porousfreezethaw.parallel.sharding import (
    freezing_sharding, make_mesh, shard_freezing_state)
from porousfreezethaw.solvers import MersonParams, merson_init, merson_solve

from tests.test_freezing_equation import default_params

MESHES = ["z2", "z4", "z8", "z2,y2", "z2,y4", "z4,y2"]
MODES = [0, 1, 2]


def make_case(dtype, n3=16, n2=8, n1=6):
    geom = GridGeometry(0.03, 0.03, 0.06, n1, n2, n3)
    prm = default_params()
    rng = np.random.RandomState(11)
    u = 273.15 + 10 * (rng.random_sample(geom.shape) - 0.5)
    p = rng.random_sample(geom.shape)
    gl = rng.random_sample(geom.shape) * 0.5
    return geom, prm, jnp.asarray(np.stack([u, p, gl]), dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", MESHES)
def test_classic_rhs_sharded_equals_single(spec, mode):
    geom, prm, w = make_case(jnp.float64)
    rhs = jax.jit(make_rhs(geom, prm, mode))
    want = np.asarray(rhs(100.0, w))
    mesh = make_mesh(spec)
    got = rhs(100.0, shard_freezing_state(w, mesh))
    assert got.sharding.is_equivalent_to(freezing_sharding(mesh), ndim=4)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("spec", MESHES)
def test_delta_solve_step_counts_mesh_invariant(spec):
    """The f32 increment-form solve takes the same accepted and attempted
    steps on every mesh, and its fields agree to f32 rounding."""
    geom, prm, w = make_case(jnp.float32)
    att = XlaDeltaAttempt(geom, prm, 0)
    params = MersonParams(delta=1e-3, h_min=1e-9, handle_nan=True)

    def run(y):
        return jax.jit(lambda s: merson_solve(
            None, s, 2.0, params, attempt_fn=att))(merson_init(y, 0.0, 1e-4))

    st1, s1 = run(w)
    stn, sn = run(shard_freezing_state(w, make_mesh(spec)))
    assert int(s1) == int(sn) == 0
    assert int(st1.steps) > 5
    assert (int(stn.steps), int(stn.steps_total)) == (
        int(st1.steps), int(st1.steps_total))
    y1, yn = np.asarray(st1.y), np.asarray(stn.y)
    scale = np.abs(y1).max(axis=(1, 2, 3), keepdims=True)
    np.testing.assert_allclose(yn / scale, y1 / scale, rtol=0, atol=1e-6)
