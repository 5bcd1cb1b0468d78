"""Explicit halo exchange under shard_map.

The default execution path lets GSPMD partition the ``jnp.roll``-based
stencil automatically.  This module is the *explicit* formulation of the
reference's distributed design (``sync_solution``, equation.c:290-326):
each device owns a contiguous z-slab, exchanges one ghost plane with each
z-neighbor via ``lax.ppermute`` around the mesh ring (the MPI_Isend/Irecv
pair), applies physical boundary conditions only at the true domain ends,
and runs the *local* stencil on the halo-augmented block.

Two reasons to have it alongside GSPMD:
* it is the building block for manually overlapping halo transfer with
  interior compute on multi-host slices (the reference's documented
  bottleneck, SURVEY §5.7), and
* it makes the communication pattern visible and testable (the halo test
  asserts shard_map == GSPMD == single-device).

The local stencil is obtained by *reusing* the global jnp RHS on the
halo-augmented block: ghost planes already hold the correct neighbor/BC
values, the interior of the local result is exact, and the (incorrectly
mirrored) ghost-plane outputs are sliced away.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.grid import GridGeometry
from ..models.freezing.equation import make_rhs
from ..models.freezing.parameters import FreezingParams
from ..models.freezing import physics


def halo_exchange_z(w_local: jax.Array, axis_name: str = "z"):
    """Exchange one ghost plane with both z-neighbors.

    Returns (from_below, from_above): the neighbor's edge plane, arriving
    over two counter-rotating ppermute rings (the nonblocking up/down
    Isend/Irecv pair of sync_solution).  At the chain ends the received
    plane is garbage (ring wrap-around) and must be replaced by the
    physical BC by the caller.
    """
    n = lax.axis_size(axis_name)
    up = [(i, (i + 1) % n) for i in range(n)]     # send toward +z
    down = [(i, (i - 1) % n) for i in range(n)]   # send toward -z
    from_below = lax.ppermute(w_local[:, -1:], axis_name, up)
    from_above = lax.ppermute(w_local[:, :1], axis_name, down)
    return from_below, from_above


def make_shard_map_rhs(geom: GridGeometry, params: FreezingParams,
                       calc_mode: int, mesh: Mesh, axis_name: str = "z"):
    """Freezing RHS with explicit per-stage halo exchange over ``mesh``.

    The state (3, n3, n2, n1) is sharded over z; returns a function with
    the same signature/semantics as ``make_rhs``'s (jittable; the 5 Merson
    stages each perform one exchange, exactly like the reference's
    per-stage sync, include/RK_MPI_SAsolver.h:112-148).
    """
    nz = mesh.shape[axis_name]
    if geom.n3 % nz:
        raise ValueError(f"n3={geom.n3} not divisible by mesh {axis_name}={nz}")
    zl = geom.n3 // nz
    # local geometry with identical cell spacing: the local rhs sees a
    # (zl+2)-plane block, so give it an L3 that keeps n3/L3 unchanged
    local_geom = GridGeometry(geom.L1, geom.L2,
                              L3=(zl + 2) / geom.n3 * geom.L3,
                              n1=geom.n1, n2=geom.n2, n3=zl + 2)
    local_rhs = make_rhs(local_geom, params, calc_mode)

    spec = P(None, axis_name, None, None)

    @partial(shard_map, mesh=mesh, in_specs=(P(), spec), out_specs=spec,
             check_vma=False)
    def rhs_sharded(t, w_local):
        idx = lax.axis_index(axis_name)
        from_below, from_above = halo_exchange_z(w_local, axis_name)

        # physical BCs at the chain ends (equation.c:164-183): mirror at
        # z=0 for all fields; at z=L3 mirror for p/gl and Dirichlet for u.
        bottom_bc = w_local[:, :1]           # mirror: first phantom = edge
        top_bc = w_local[:, -1:]
        dtype = w_local.dtype
        d_val = physics.dirichlet_top(jnp.asarray(t, dtype), params)
        top_bc = top_bc.at[0].set(jnp.asarray(d_val, dtype))

        below = jnp.where(idx == 0, bottom_bc, from_below)
        above = jnp.where(idx == nz - 1, top_bc, from_above)

        padded = jnp.concatenate([below, w_local, above], axis=1)
        return local_rhs(t, padded)[:, 1:-1]

    return rhs_sharded


def shard_spec(mesh: Mesh, axis_name: str = "z") -> NamedSharding:
    return NamedSharding(mesh, P(None, axis_name, None, None))
