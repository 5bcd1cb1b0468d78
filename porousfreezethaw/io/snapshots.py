"""Snapshot / checkpoint datasets for the freezing simulator.

Reproduces the reference's NetCDF snapshot contract
(``intertrack.c:2297-2455``):

* filename ``{out_file}.{snapshot:03d}{suffix}``; on-demand snapshots
  ``{out_file}.{snapshot:03d}.{on_demand:03d}{suffix}``
* dimensions ``n3, n2, n1`` with double coordinate variables of the same
  names holding the cell-center coordinates
* double field variables ``u, p, gl`` with dims (n3, n2, n1)
* global attributes: L1..L3, every model parameter by name, ``calc_mode``
  (int), ``delta``, ``tau`` (the *current* continuation step), ``t``,
  ``final_time``, ``snapshot``, ``total_snapshots`` (ints), and ``title``
  built as "Intertrack simulation (<comment>). Time: <t>"
  (``intertrack.c:1129, 2370-2406``)

Every snapshot is a complete checkpoint: ``load_checkpoint`` restores the
state for `continue_series` resume (``intertrack.c:1642-1669``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.grid import GridGeometry
from ..models.freezing.parameters import FreezingParams, PARAM_NAMES, VARIABLES
from .netcdf3 import (NC_DOUBLE, create_netcdf, read_netcdf, write_block,
                      write_netcdf)


def snapshot_filename(out_file: str, snapshot: int, suffix: str,
                      on_demand: Optional[int] = None) -> str:
    if on_demand is not None:
        return f"{out_file}.{snapshot:03d}.{on_demand:03d}{suffix}"
    return f"{out_file}.{snapshot:03d}{suffix}"


BCOND_THICKNESS = 2  # equation.c:38


def write_snapshot(
    path: str,
    geom: GridGeometry,
    params: FreezingParams,
    state_fields: np.ndarray,       # (3, n3, n2, n1)
    *,
    calc_mode: int,
    delta: float,
    tau: float,
    t: float,
    final_time: float,
    snapshot: int,
    total_snapshots: int,
    comment: str = "",
    grid_mode: str = "inner",
) -> None:
    """``grid_mode='full'`` reproduces the reference's troubleshooting
    output including the bcond_thickness=2 ghost layer (grid_IO_mode==0,
    intertrack.c:2338-2340,2436-2446): mirror ghosts everywhere, both
    temperature ghost planes at the z-top set to the Dirichlet value."""
    fields = np.asarray(state_fields, dtype=np.float64)
    b = BCOND_THICKNESS if grid_mode == "full" else 0
    if grid_mode == "full":
        # FVM mirror: first phantom = adjacent interior (np 'symmetric')
        fields = np.pad(fields, ((0, 0),) + ((b, b),) * 3, mode="symmetric")
        d_val = (params.top_temp1 if t < params.phase_switch_time
                 else params.top_temp2)
        fields[0, -b:, :, :] = d_val

    k = np.arange(fields.shape[1], dtype=np.float64)
    j = np.arange(fields.shape[2], dtype=np.float64)
    i = np.arange(fields.shape[3], dtype=np.float64)
    z = geom.L3 * (0.5 + k - b) / geom.n3
    y = geom.L2 * (0.5 + j - b) / geom.n2
    x = geom.L1 * (0.5 + i - b) / geom.n1

    dims = {"n3": fields.shape[1], "n2": fields.shape[2],
            "n1": fields.shape[3]}
    variables = [
        ("n3", ("n3",), z), ("n2", ("n2",), y), ("n1", ("n1",), x),
    ]
    for q, name in enumerate(VARIABLES):
        variables.append((name, ("n3", "n2", "n1"), fields[q]))

    attrs = _snapshot_attrs(
        geom, params, calc_mode=calc_mode, delta=delta, tau=tau, t=t,
        final_time=final_time, snapshot=snapshot,
        total_snapshots=total_snapshots, comment=comment)

    write_netcdf(path, dims, variables, attrs)


def _snapshot_attrs(geom, params, *, calc_mode, delta, tau, t, final_time,
                    snapshot, total_snapshots, comment):
    attrs: Dict[str, object] = {"L1": geom.L1, "L2": geom.L2, "L3": geom.L3}
    pdict = params.as_dict()
    for name in PARAM_NAMES:
        attrs[name] = float(pdict[name])
    attrs["calc_mode"] = int(calc_mode)
    attrs["delta"] = float(delta)
    attrs["tau"] = float(tau)
    attrs["t"] = float(t)
    attrs["final_time"] = float(final_time)
    attrs["snapshot"] = int(snapshot)
    attrs["total_snapshots"] = int(total_snapshots)
    attrs["title"] = f"Intertrack simulation ({comment}). Time: {t:g}"
    return attrs


def write_snapshot_sharded(
    path: str,
    geom: GridGeometry,
    params: FreezingParams,
    state,                          # jax.Array (3, n3, n2, n1), any sharding
    *,
    calc_mode: int,
    delta: float,
    tau: float,
    t: float,
    final_time: float,
    snapshot: int,
    total_snapshots: int,
    comment: str = "",
    u_shift: float = 0.0,
) -> None:
    """Gather-free snapshot write: the same NetCDF contract as
    :func:`write_snapshot`, but each device shard's block is written
    directly into its hyperslab of the file (the per-host sharded
    equivalent of the reference's gather-to-master + nc_put_vara loop,
    ``intertrack.c:2459-2546``) — the global array is never materialized
    on any host.

    ``u_shift`` is added to the temperature per shard in the state's
    own dtype, matching the gathered path's ``_unshift`` arithmetic
    byte-for-byte.

    Single-process: writes every shard.  Multi-host: process 0 creates
    the file with header + coordinates, then every process writes only
    its *addressable* shards (shared filesystem assumed); inner-grid
    output only.
    """
    import jax

    if state.shape[0] != len(VARIABLES):
        raise ValueError(f"state leading dim {state.shape[0]} != "
                         f"{len(VARIABLES)} variables")
    if state.shape[1:] != (geom.n3, geom.n2, geom.n1):
        raise ValueError(f"state shape {state.shape} does not match the "
                         f"grid ({geom.n3}, {geom.n2}, {geom.n1})")
    n3, n2, n1 = state.shape[1:]
    dims = {"n3": n3, "n2": n2, "n1": n1}
    var_specs = [("n3", ("n3",), NC_DOUBLE), ("n2", ("n2",), NC_DOUBLE),
                 ("n1", ("n1",), NC_DOUBLE)]
    for name in VARIABLES:
        var_specs.append((name, ("n3", "n2", "n1"), NC_DOUBLE))
    attrs = _snapshot_attrs(
        geom, params, calc_mode=calc_mode, delta=delta, tau=tau, t=t,
        final_time=final_time, snapshot=snapshot,
        total_snapshots=total_snapshots, comment=comment)

    if jax.process_index() == 0:
        layouts = create_netcdf(path, dims, var_specs, attrs)
        z = geom.L3 * (0.5 + np.arange(n3)) / geom.n3
        y = geom.L2 * (0.5 + np.arange(n2)) / geom.n2
        x = geom.L1 * (0.5 + np.arange(n1)) / geom.n1
        write_block(path, layouts["n3"], z, (0,))
        write_block(path, layouts["n2"], y, (0,))
        write_block(path, layouts["n1"], x, (0,))
    else:
        # offsets are a pure function of (dims, var_specs, attrs):
        # recompute instead of communicating
        from .netcdf3 import _build_header
        _, layouts, _ = _build_header(dims, var_specs, attrs)

    seen = set()
    for shard in state.addressable_shards:
        if shard.replica_id != 0:
            continue
        idx = shard.index  # tuple of slices into the (sharded) state
        key = tuple((s.start, s.stop) for s in idx)
        if key in seen:
            continue
        seen.add(key)
        qs = idx[0]
        q0 = qs.start or 0
        raw = np.asarray(shard.data)
        if u_shift and q0 == 0:
            raw = np.array(raw, copy=True)
            raw[0] += u_shift
        block = raw.astype(np.float64)
        spatial_start = tuple(s.start or 0 for s in idx[1:])
        for qi, q in enumerate(range(q0,
                                     qs.stop if qs.stop is not None
                                     else state.shape[0])):
            write_block(path, layouts[VARIABLES[q]], block[qi],
                        spatial_start)


@dataclasses.dataclass
class Checkpoint:
    fields: np.ndarray              # (3, n3, n2, n1)
    geom_dims: Tuple[int, int, int]  # (n1, n2, n3)
    t: float
    tau: float
    snapshot: int
    total_snapshots: int
    final_time: float
    attrs: Dict[str, object]


def load_checkpoint(path: str) -> Checkpoint:
    """Read a snapshot for icond loading / continue_series resume
    (intertrack.c:1598-1689, 2023-2117)."""
    data = read_netcdf(path)
    missing = [v for v in VARIABLES if v not in data.variables]
    if missing:
        raise ValueError(f"{path}: dataset lacks variables {missing}")
    fields = np.stack([np.asarray(data.variables[v], dtype=np.float64)
                       for v in VARIABLES])
    a = data.attrs
    return Checkpoint(
        fields=fields,
        geom_dims=(data.dims["n1"], data.dims["n2"], data.dims["n3"]),
        t=float(a.get("t", 0.0)),
        tau=float(a.get("tau", 1.0)),
        snapshot=int(a.get("snapshot", 0)),
        total_snapshots=int(a.get("total_snapshots", 0)),
        final_time=float(a.get("final_time", 0.0)),
        attrs=dict(a),
    )
