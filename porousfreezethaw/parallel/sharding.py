"""Device mesh and sharding for the freezing grid.

The reference scales with a 1-D slab decomposition of the grid along Z over
MPI ranks, ghost layers exchanged per RK stage
(``intertrack.c:1776-1789``, ``equation.c:290-326``).  The equivalent here
shards the state array ``(VAR, Z, Y, X)`` over a
``jax.sharding.Mesh``:

* axis ``z`` shards the Z dimension (the reference's decomposition),
* axis ``y`` optionally shards Y as well — a 2-D decomposition the
  reference cannot do (SURVEY §5.7).

Under ``jit``, the stencil's ``jnp.roll`` along a sharded axis lowers to a
``collective-permute`` (the halo exchange; NCCL between GPUs) and the
Merson controller's global error max to an ``all-reduce``.  No master rank exists: every device computes identical step-
control scalars from the same deterministic collectives, which supersedes
the reference's command-broadcast discipline (``RK_MPI_SAsolver.c:320-331``).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(spec: str = "z", devices: Optional[Sequence] = None) -> Mesh:
    """Build a device mesh from a spec like ``'z'``, ``'z4'``, ``'z2,y4'``.

    An axis without an explicit size absorbs all remaining devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    axes = []
    free_axis = None
    fixed = 1
    for part in spec.split(","):
        m = re.fullmatch(r"([a-z]+)(\d*)", part.strip())
        if not m:
            raise ValueError(f"bad mesh spec part {part!r}")
        name, size = m.group(1), m.group(2)
        if size:
            axes.append((name, int(size)))
            fixed *= int(size)
        else:
            if free_axis is not None:
                raise ValueError("only one mesh axis may have implicit size")
            free_axis = name
            axes.append((name, None))
    if free_axis is not None:
        if len(devices) % fixed:
            raise ValueError(
                f"{len(devices)} devices not divisible by fixed axes ({fixed})")
        axes = [(n, s if s else len(devices) // fixed) for n, s in axes]
    total = int(np.prod([s for _, s in axes]))
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:total]).reshape([s for _, s in axes])
    return Mesh(dev_array, [n for n, _ in axes])


def freezing_sharding(mesh: Mesh) -> NamedSharding:
    """NamedSharding for the state (VAR, Z, Y, X): Z over 'z', Y over 'y'
    (when those axes exist in the mesh), VAR and X replicated."""
    z = "z" if "z" in mesh.axis_names else None
    y = "y" if "y" in mesh.axis_names else None
    return NamedSharding(mesh, P(None, z, y, None))


def shard_freezing_state(w: jax.Array, mesh: Mesh) -> jax.Array:
    """Place the state on the mesh with the freezing decomposition.
    The sharded dimensions must be divisible by the mesh axis sizes."""
    sh = freezing_sharding(mesh)
    zsize = mesh.shape.get("z", 1)
    ysize = mesh.shape.get("y", 1)
    if w.shape[1] % zsize or w.shape[2] % ysize:
        raise ValueError(
            f"grid {w.shape[1:]} not divisible by mesh z={zsize}, y={ysize}")
    return jax.device_put(w, sh)


def dem_sharding(mesh: Mesh, axis: str = "p") -> NamedSharding:
    """NamedSharding for DEM state leaves ``(n, 3)``: particles over
    ``axis``, components replicated.

    The reference DEM is OpenMP-only — MPI explicitly "not supported"
    (``spheres_friction_angular.c:614-616``).  On a device mesh the masked
    dense pair scan is row-parallel over particles: sharding the particle
    axis makes GSPMD partition the (n, n, 3) pair intermediates by rows
    and all-gather the neighbor side, while the Merson
    controller's error max becomes the one global all-reduce per attempt
    — mesh-size-invariant results, exactly like the freezing grid."""
    return NamedSharding(mesh, P(axis, None))


def shard_dem_state(y: dict, mesh: Mesh, axis: str = "p") -> dict:
    """Place a DEM state pytree ``{'pos','vel'[,'angvel']}: (n, 3)`` on
    the mesh, particles sharded over ``axis`` (n must be divisible)."""
    size = mesh.shape.get(axis, 1)
    sh = dem_sharding(mesh, axis)
    out = {}
    for k, v in y.items():
        if v.shape[0] % size:
            raise ValueError(
                f"n={v.shape[0]} not divisible by mesh {axis}={size}")
        out[k] = jax.device_put(v, sh)
    return out
