"""Vectorized DEM soft-contact force kernels.

The reference computes per-particle accelerations with an O(n^2) pair scan
under OpenMP (``spheres_friction_angular.c:242-357``).  Four vectorized
neighbor strategies share one pair-force model (the scalable ones are the
analog of the cutoff scan in ``spheres_basic.c:222-286``; the reference
has no cell structure at all — SURVEY §2.6 tasks this build with one):

* ``dense`` — masked (n x n) pairwise computation: exact, no data
  structure; the right choice for the reference's n = 200 workloads and
  the correctness oracle for every cell strategy.
* ``cell_list`` — fixed-capacity spatial bins + per-particle candidate
  GATHERS from the 27 surrounding cells: O(n * 27 * capacity) work with
  irregular access.
* ``cell_roll`` — cell-major (nz, ny, nx, K) grid, neighbors as whole-
  grid rolls: regular access, with (K, K) pair blocks in the minor dims.
* ``cell_lanes`` — the flattened cell axis minor, capacity next,
  neighbors as rolls along the cell axis — no gathers in the pair loop
  (``make_cell_lanes``).

Which strategy wins at which n on the GPU is not measured yet.

Force model (constants in :class:`..config.DEMConfig`):
* collision factor  CF = cfm * exp(-cfe * surf_dist)  (exp model,
  spheres_basic.c:202-207) or the Walton–Braun spring
  ``CF = -k * surf_dist`` for overlap only (spheres_basic_WB.c:207-209)
* velocity-dependent rebound factor  COR^2..1 via tanh
  (spheres_basic.c:192-200)
* tangential friction  FF = CF * mu_f * S(|v_t|)  with the S-shape
  low-velocity limiter (spheres_friction.c:230-240)
* rotation: surface velocity omega x r added to the tangential velocity,
  torque tau = r*FF/I applied to angular acceleration
  (spheres_friction_angular.c:298-321, 339-354)

State pytree: {'pos': (n,3), 'vel': (n,3)[, 'angvel': (n,3)]}.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .config import DEMConfig

# 27 neighbor-cell offsets (own cell included)
_OFFSETS = [(dx, dy, dz)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _cross(a, b):
    return jnp.cross(a, b)


def default_cell_bounds(cfg: DEMConfig) -> Tuple[Tuple[float, float, float],
                                                 Tuple[float, float, float]]:
    """Bounding box for the cell grid: the vessel plus headroom for the
    elevated initial block and slack for wall penetration overshoot.

    The height model matches ``icond_dense`` (the tallest initializer):
    ``floor(R / 2.5r)^2`` spheres per layer at spacing ``R / bpr``
    (spheres_friction_angular.c:454-489) — NOT ``n^(1/3)`` layers, which
    underestimates badly for large n (particles above the box were
    clip-binned into the top cell layer, overflowing its capacity and
    silently dropping pairs; caught in round 4 by the occupancy check
    at n = 20 000)."""
    bpr = max(1, math.floor(cfg.R / (2.5 * cfg.r)))
    distance = cfg.R / bpr
    n_layers = math.ceil(cfg.n / (bpr * bpr))
    z_top = cfg.h0 + (n_layers + 2) * distance
    pad = 4.0 * cfg.r
    return (-pad, -pad, -pad), (cfg.R + pad, cfg.R + pad, z_top + pad)


def make_cell_list(cfg: DEMConfig, capacity: int = 16,
                   bounds=None, dtype=jnp.float64):
    """Build ``neighbor_ids(pos) -> (ids, mask)`` where ``ids`` is
    (n, 27*capacity) candidate indices (clipped to valid range) and
    ``mask`` marks real candidates.  Cell edge = the interaction range
    2r + max_surf_dist, so all interacting pairs lie within the 27
    surrounding cells.  A cell holding more than ``capacity`` particles
    silently drops the excess — with edge 3r and radius r at most ~8
    sphere centers fit a cell, so the default 16 has 2x headroom;
    ``cell_occupancy`` measures the true maximum for a configuration."""
    lo, hi = bounds if bounds is not None else default_cell_bounds(cfg)
    edge = 2.0 * cfg.r + cfg.max_surf_dist
    dims = tuple(int(math.ceil((hi[d] - lo[d]) / edge)) for d in range(3))
    nx, ny, nz = dims
    ncells = nx * ny * nz
    lo_arr = jnp.asarray(lo, dtype)
    n = cfg.n

    def cell_coords(pos):
        ci = jnp.floor((pos - lo_arr) / edge).astype(jnp.int32)
        return jnp.clip(ci, 0, jnp.asarray(dims, jnp.int32) - 1)

    def neighbor_ids(pos):
        ci = cell_coords(pos)
        cid = (ci[:, 2] * ny + ci[:, 1]) * nx + ci[:, 0]
        order = jnp.argsort(cid).astype(jnp.int32)
        scid = cid[order]
        first = jnp.searchsorted(scid, scid, side="left").astype(jnp.int32)
        rank = jnp.arange(n, dtype=jnp.int32) - first
        table = jnp.full((ncells * capacity,), -1, jnp.int32)
        slot = scid * capacity + jnp.minimum(rank, capacity - 1)
        table = table.at[slot].set(order)

        offs = jnp.asarray(_OFFSETS, jnp.int32)            # (27, 3)
        cand_ci = ci[:, None, :] + offs[None, :, :]        # (n, 27, 3)
        in_range = jnp.all(
            (cand_ci >= 0) & (cand_ci < jnp.asarray(dims, jnp.int32)),
            axis=-1)                                       # (n, 27)
        cand_cid = ((cand_ci[..., 2] * ny + cand_ci[..., 1]) * nx
                    + cand_ci[..., 0])
        cand_cid = jnp.where(in_range, cand_cid, 0)
        slots = (cand_cid[..., None] * capacity
                 + jnp.arange(capacity, dtype=jnp.int32))  # (n, 27, C)
        ids = table[slots.reshape(n, -1)]                  # (n, 27*C)
        mask = ((ids >= 0)
                & jnp.repeat(in_range, capacity, axis=1)
                & (ids != jnp.arange(n, dtype=jnp.int32)[:, None]))
        return jnp.maximum(ids, 0), mask

    def cell_occupancy(pos):
        """Maximum particles per cell — must stay <= capacity."""
        ci = cell_coords(jnp.asarray(pos))
        cid = (ci[:, 2] * ny + ci[:, 1]) * nx + ci[:, 0]
        counts = jnp.zeros((ncells,), jnp.int32).at[cid].add(1)
        return int(jnp.max(counts))

    neighbor_ids.dims = dims
    neighbor_ids.capacity = capacity
    neighbor_ids.cell_occupancy = cell_occupancy
    return neighbor_ids


def make_cell_matrix(cfg: DEMConfig, capacity: int = 16, bounds=None,
                     dtype=jnp.float64):
    """Neighbor structure ``bin(pos) -> (slot, grid_valid)`` for the
    cell-ROLL strategy.  Particles are scattered into a cell-major,
    capacity-padded array; the 27 neighbor cells of every cell are then
    *rolls* of the (nz, ny, nx, K) grid — contiguous moves — instead of
    the per-row ``(n, 27*K)`` gather of ``make_cell_list``.  Work is
    O(ncells * 27 * K^2); the only irregular ops
    are one scatter (state -> cell-major) and one row gather
    (accelerations -> particle order) per evaluation.

    Overflow semantics match make_cell_list: particles beyond
    ``capacity`` in one cell collapse onto the last slot (last write
    wins) — use ``cell_occupancy`` to validate a configuration."""
    lo, hi = bounds if bounds is not None else default_cell_bounds(cfg)
    edge = 2.0 * cfg.r + cfg.max_surf_dist
    dims = tuple(int(math.ceil((hi[d] - lo[d]) / edge)) for d in range(3))
    nx, ny, nz = dims
    ncells = nx * ny * nz
    lo_arr = jnp.asarray(lo, dtype)
    n = cfg.n
    K = capacity

    def cell_coords(pos):
        ci = jnp.floor((pos - lo_arr) / edge).astype(jnp.int32)
        return jnp.clip(ci, 0, jnp.asarray(dims, jnp.int32) - 1)

    def bin_particles(pos):
        ci = cell_coords(pos)
        cid = (ci[:, 2] * ny + ci[:, 1]) * nx + ci[:, 0]
        order = jnp.argsort(cid).astype(jnp.int32)
        scid = cid[order]
        first = jnp.searchsorted(scid, scid, side="left").astype(jnp.int32)
        rank = jnp.arange(n, dtype=jnp.int32) - first
        # slot of the k-th particle of its cell, in ORIGINAL order
        slot_sorted = scid * K + jnp.minimum(rank, K - 1)
        slot = jnp.zeros((n,), jnp.int32).at[order].set(slot_sorted)
        valid = jnp.zeros((ncells * K,), bool).at[slot].set(True)
        return slot, valid

    def to_cells(slot, x):
        """(n, 3) particle array -> (nz, ny, nx, K, 3) cell-major."""
        flat = jnp.zeros((ncells * K, x.shape[-1]), x.dtype).at[slot].set(x)
        return flat.reshape(nz, ny, nx, K, x.shape[-1])

    bin_particles.dims = dims
    bin_particles.capacity = K
    bin_particles.to_cells = to_cells
    # reuse the occupancy validator of the gather-based structure
    bin_particles.cell_occupancy = make_cell_list(
        cfg, capacity=K, bounds=bounds, dtype=dtype).cell_occupancy
    return bin_particles


def make_cell_lanes(cfg: DEMConfig, capacity: int = 16, bounds=None,
                    dtype=jnp.float64):
    """Neighbor structure with the flattened cell axis minor and the
    capacity next to it.

    Every per-cell array is stored ``(K, C)`` with ``C`` the 128-padded
    flattened cell count, so pair blocks are ``(K, K, C)``: the minor
    axis carries whole cells, the next one the K-capacity (K a multiple
    of 8), and the 27 neighbor-cell accesses are rolls by
    ``ox + nx*(oy + ny*oz)`` along the cell axis — regular moves, no
    gathers in the pair loop.  ``C`` is padded past
    ``ncells + max|shift|`` so a roll never wraps a real cell onto a
    real cell; wrapped lanes land in the pad region, whose slots are
    invalid.

    Overflow semantics match the other cell structures (capacity
    collapse onto the last slot, ``cell_occupancy`` validates)."""
    lo, hi = bounds if bounds is not None else default_cell_bounds(cfg)
    edge = 2.0 * cfg.r + cfg.max_surf_dist
    dims = tuple(int(math.ceil((hi[d] - lo[d]) / edge)) for d in range(3))
    nx, ny, nz = dims
    ncells = nx * ny * nz
    max_shift = 1 + nx * (1 + ny)
    C = -(-(ncells + max_shift + 1) // 128) * 128
    lo_arr = jnp.asarray(lo, dtype)
    n = cfg.n
    K = capacity

    def cell_coords(pos):
        ci = jnp.floor((pos - lo_arr) / edge).astype(jnp.int32)
        return jnp.clip(ci, 0, jnp.asarray(dims, jnp.int32) - 1)

    def bin_particles(pos):
        """-> (slot, valid, overflow): slot[i] = k*C + cid of particle i
        in the (K, C) layout; valid marks occupied slots; overflow is a
        device scalar bool — True when any cell holds more than K
        particles (the excess would collapse onto the last slot and
        silently drop pairs, so the force kernel poisons its output with
        NaN instead — the guarded-capacity contract)."""
        ci = cell_coords(pos)
        cid = (ci[:, 2] * ny + ci[:, 1]) * nx + ci[:, 0]
        order = jnp.argsort(cid).astype(jnp.int32)
        scid = cid[order]
        first = jnp.searchsorted(scid, scid, side="left").astype(jnp.int32)
        raw_rank = jnp.arange(n, dtype=jnp.int32) - first
        overflow = jnp.max(raw_rank) >= K
        rank = jnp.minimum(raw_rank, K - 1)
        slot_sorted = rank * C + scid
        slot = jnp.zeros((n,), jnp.int32).at[order].set(slot_sorted)
        valid = jnp.zeros((K * C,), bool).at[slot].set(True)
        return slot, valid.reshape(K, C), overflow

    def to_kc(slot, x):
        """(n, 3) particle array -> (3, K, C) component-major."""
        flat = jnp.zeros((K * C, 3), x.dtype).at[slot].set(x)
        return jnp.moveaxis(flat.reshape(K, C, 3), -1, 0)

    bin_particles.dims = dims
    bin_particles.capacity = K
    bin_particles.C = C
    bin_particles.ncells = ncells
    bin_particles.to_kc = to_kc
    bin_particles.cell_occupancy = make_cell_list(
        cfg, capacity=K, bounds=bounds, dtype=dtype).cell_occupancy
    return bin_particles


def make_dem_rhs(cfg: DEMConfig, dtype=jnp.float64, neighbor: str = "dense",
                 cell_capacity: int = 16, cell_bounds=None, mesh=None,
                 axis_name: str = "p"):
    """Build ``rhs(t, y) -> dy/dt`` for the configured variant.
    ``neighbor``: 'dense' (exact masked n x n) or 'cell_list'.

    ``mesh``: optional ``jax.sharding.Mesh`` with a particle axis
    ``axis_name`` — the rhs then runs as an explicit ``shard_map``: each
    shard computes its particle rows against the full ``all_gather``-ed
    state, so every row's neighbor sum has exactly the single-device
    summation order and results are **bitwise** mesh-size invariant (the
    step-count oracle of SURVEY §4.2, extended to the DEM, which the
    reference cannot distribute at all —
    ``spheres_friction_angular.c:614-616``).  Plain GSPMD sharding without
    this reshards the (n, n, 3) pair tensor and turns the neighbor sum
    into partial sums + all-reduce, changing the rounding."""
    P_w, n_w = cfg.wall_arrays()
    kin_energy_fraction = cfg.COR * cfg.COR
    two_r = 2.0 * cfg.r
    eps2_3 = 3.0 / (cfg.p_eps1 * cfg.p_eps1)
    eps3_2 = 2.0 / (cfg.p_eps1 * cfg.p_eps1 * cfg.p_eps1)

    def rebound(v):
        # smooth restitution: ~1 for v>0, ~COR^2 for v<0 (spheres_basic.c:192)
        return kin_energy_fraction + 0.5 * (1.0 - kin_energy_fraction) * (
            1.0 + jnp.tanh(v * cfg.dissipation_focusing))

    if cfg.variant == "basic_WB":
        def collision_factor(surf):
            return jnp.where(surf > 0, 0.0, -cfg.WB_stiffness * surf)
    else:
        def collision_factor(surf):
            return cfg.collision_force_multiplier * jnp.exp(
                -cfg.collision_force_exponent * surf)

    def friction_factor(x):
        lim = x * x * (eps2_3 - eps3_2 * x)
        return jnp.where(x >= cfg.p_eps1, 1.0, lim)

    gravity = jnp.asarray(cfg.gravity, dtype)
    walls_P = jnp.asarray(P_w, dtype)
    walls_n = jnp.asarray(n_w, dtype)

    neighbor_struct = None
    if neighbor == "cell_list":
        nbr_fn = neighbor_struct = make_cell_list(
            cfg, capacity=cell_capacity, bounds=cell_bounds, dtype=dtype)
    elif neighbor == "cell_roll":
        binner = neighbor_struct = make_cell_matrix(
            cfg, capacity=cell_capacity, bounds=cell_bounds, dtype=dtype)
    elif neighbor == "cell_lanes":
        lanes = neighbor_struct = make_cell_lanes(
            cfg, capacity=cell_capacity, bounds=cell_bounds, dtype=dtype)
    elif neighbor != "dense":
        raise ValueError(f"unknown neighbor strategy {neighbor!r}")

    def pair_accels(pos, vel, angvel, npos, nvel, nangvel, mask):
        """Summed contact acceleration (and angular acceleration) on each
        particle from its candidate neighbors (n, m, 3)."""
        dp = pos[:, None, :] - npos                     # i w.r.t. j
        dist = jnp.linalg.norm(dp, axis=-1) + cfg.zero
        mp = dp / dist[..., None]
        surf = dist - two_r
        mask = mask & (surf <= cfg.max_surf_dist)
        CF = jnp.where(mask, collision_factor(surf), 0.0)

        mv = vel[:, None, :] - nvel
        heading = jnp.sum(mv * mp, axis=-1)
        acc = jnp.sum((CF * rebound(-heading))[..., None] * mp, axis=1)

        angacc = None
        if cfg.has_friction:
            mv_t = mv - heading[..., None] * mp
            if angvel is not None:
                # mp points opposite to r (center -> contact point):
                # v_surf contribution is -r * (omega_i + omega_j) x mp
                sv = _cross(angvel[:, None, :] + nangvel, mp)
                mv_t = mv_t - cfg.r * sv
            mvt_mag = jnp.linalg.norm(mv_t, axis=-1) + cfg.zero
            tdir = mv_t / mvt_mag[..., None]
            FF = CF * cfg.friction * friction_factor(mvt_mag)
            acc = acc - jnp.sum(FF[..., None] * tdir, axis=1)
            if angvel is not None:
                torque = _cross(mp, tdir)
                angacc = jnp.sum(
                    (cfg.r * FF / cfg.inertia)[..., None] * torque, axis=1)
        return acc, angacc

    def cell_roll_accels(pos, vel, angvel):
        """Pair accelerations via the cell-major roll strategy: the
        27 neighbor cells are rolls of the (nz, ny, nx, K) grid; each
        offset contributes a fully regular (cells, K, K) block of pair
        interactions.  No gathers in the pair loop."""
        nx_, ny_, nz_ = binner.dims
        K = binner.capacity
        slot, valid = binner(pos)
        Xp = binner.to_cells(slot, pos)
        Xv = binner.to_cells(slot, vel)
        Xa = binner.to_cells(slot, angvel) if angvel is not None else None
        Vg = valid.reshape(nz_, ny_, nx_, K)
        N = nz_ * ny_ * nx_ * K
        own_pos = Xp.reshape(N, 3)
        own_vel = Xv.reshape(N, 3)
        own_ang = Xa.reshape(N, 3) if Xa is not None else None
        iz = jnp.arange(nz_, dtype=jnp.int32)[:, None, None]
        iy = jnp.arange(ny_, dtype=jnp.int32)[None, :, None]
        ix = jnp.arange(nx_, dtype=jnp.int32)[None, None, :]
        own_valid = Vg.reshape(N)
        acc = jnp.zeros((N, 3), pos.dtype)
        angacc = (jnp.zeros((N, 3), pos.dtype)
                  if angvel is not None else None)
        eye = jnp.eye(K, dtype=bool)
        for ox, oy, oz in _OFFSETS:
            sh = (-oz, -oy, -ox)
            Yp = jnp.roll(Xp, sh, axis=(0, 1, 2))
            Yv = jnp.roll(Xv, sh, axis=(0, 1, 2))
            Ya = (jnp.roll(Xa, sh, axis=(0, 1, 2))
                  if Xa is not None else None)
            Yvalid = jnp.roll(Vg, sh, axis=(0, 1, 2))
            in_range = ((iz + oz >= 0) & (iz + oz < nz_)
                        & (iy + oy >= 0) & (iy + oy < ny_)
                        & (ix + ox >= 0) & (ix + ox < nx_))
            mask = (Vg[..., :, None] & Yvalid[..., None, :]
                    & in_range[..., None, None])
            if (ox, oy, oz) == (0, 0, 0):
                mask = mask & ~eye
            mflat = mask.reshape(N, K)
            npos = jnp.broadcast_to(
                Yp[..., None, :, :],
                (nz_, ny_, nx_, K, K, 3)).reshape(N, K, 3)
            nvel = jnp.broadcast_to(
                Yv[..., None, :, :],
                (nz_, ny_, nx_, K, K, 3)).reshape(N, K, 3)
            nang = (jnp.broadcast_to(
                Ya[..., None, :, :],
                (nz_, ny_, nx_, K, K, 3)).reshape(N, K, 3)
                if Ya is not None else None)
            a, aa = pair_accels(own_pos, own_vel, own_ang,
                                npos, nvel, nang, mflat)
            acc = acc + a
            if aa is not None:
                angacc = angacc + aa
        # masked slots carry garbage-free zeros; map back to particles
        acc = jnp.where(own_valid[:, None], acc, 0.0)[slot]
        if angacc is not None:
            angacc = jnp.where(own_valid[:, None], angacc, 0.0)[slot]
        return acc, angacc

    def cell_lanes_accels(pos, vel, angvel):
        """Pair accelerations in the lane-major (K, C) cell layout (see
        ``make_cell_lanes``): component axis leading, cells in lanes,
        neighbors as flat-axis rolls.  Same physics as ``pair_accels``,
        re-expressed with reductions over the leading component axis —
        the dense path is the correctness oracle
        (tests/test_dem_celllist.py)."""
        nx_, ny_, nz_ = lanes.dims
        K = lanes.capacity
        C = lanes.C
        slot, valid, overflow = lanes(pos)
        Pc = lanes.to_kc(slot, pos)          # (3, K, C)
        Vc = lanes.to_kc(slot, vel)
        Ac = lanes.to_kc(slot, angvel) if angvel is not None else None

        c = jnp.arange(C, dtype=jnp.int32)
        ix = c % nx_
        iy = (c // nx_) % ny_
        iz = c // (nx_ * ny_)
        real = c < lanes.ncells

        acc = jnp.zeros((3, K, C), pos.dtype)
        angacc = jnp.zeros((3, K, C), pos.dtype) if angvel is not None \
            else None
        eye = jnp.eye(K, dtype=bool)
        for ox, oy, oz in _OFFSETS:
            s = ox + nx_ * (oy + ny_ * oz)
            Yp = jnp.roll(Pc, -s, axis=2) if s else Pc
            Yv = jnp.roll(Vc, -s, axis=2) if s else Vc
            Ya = (jnp.roll(Ac, -s, axis=2) if s else Ac) \
                if Ac is not None else None
            Yvalid = jnp.roll(valid, -s, axis=1) if s else valid
            in_range = (real
                        & (ix + ox >= 0) & (ix + ox < nx_)
                        & (iy + oy >= 0) & (iy + oy < ny_)
                        & (iz + oz >= 0) & (iz + oz < nz_))
            mask = (valid[:, None, :] & Yvalid[None, :, :]
                    & in_range[None, None, :])        # (K, K, C)
            if (ox, oy, oz) == (0, 0, 0):
                mask = mask & ~eye[:, :, None]
            dp = Pc[:, :, None, :] - Yp[:, None, :, :]  # (3, K, K, C)
            dist = jnp.sqrt(jnp.sum(dp * dp, axis=0)) + cfg.zero
            mp = dp / dist[None]
            surf = dist - two_r
            mask = mask & (surf <= cfg.max_surf_dist)
            CF = jnp.where(mask, collision_factor(surf), 0.0)
            mv = Vc[:, :, None, :] - Yv[:, None, :, :]
            heading = jnp.sum(mv * mp, axis=0)          # (K, K, C)
            acc = acc + jnp.sum((CF * rebound(-heading))[None] * mp,
                                axis=2)
            if cfg.has_friction:
                mv_t = mv - heading[None] * mp
                if Ac is not None:
                    osum = Ac[:, :, None, :] + Ya[:, None, :, :]
                    sv = jnp.cross(osum, mp, axisa=0, axisb=0, axisc=0)
                    mv_t = mv_t - cfg.r * sv
                mvt_mag = jnp.sqrt(jnp.sum(mv_t * mv_t, axis=0)) + cfg.zero
                tdir = mv_t / mvt_mag[None]
                FF = CF * cfg.friction * friction_factor(mvt_mag)
                acc = acc - jnp.sum(FF[None] * tdir, axis=2)
                if Ac is not None:
                    torque = jnp.cross(mp, tdir, axisa=0, axisb=0, axisc=0)
                    angacc = angacc + jnp.sum(
                        (cfg.r * FF / cfg.inertia)[None] * torque, axis=2)
        # map slots back to particles (invalid slots hold exact zeros)
        flat_a = acc.reshape(3, K * C)
        out_a = jnp.stack([flat_a[d][slot] for d in range(3)], axis=-1)
        # guarded capacity: a cell past K particles would have silently
        # dropped pairs — poison the result instead so the failure is
        # loud (the solver's NaN handling rejects the step; the drivers
        # additionally check cell_occupancy at chunk boundaries and
        # raise with a clear message / fall back to dense)
        out_a = jnp.where(overflow, jnp.asarray(jnp.nan, out_a.dtype),
                          out_a)
        out_aa = None
        if angacc is not None:
            flat_aa = angacc.reshape(3, K * C)
            out_aa = jnp.stack([flat_aa[d][slot] for d in range(3)],
                               axis=-1)
            out_aa = jnp.where(overflow,
                               jnp.asarray(jnp.nan, out_aa.dtype), out_aa)
        return out_a, out_aa

    def rhs(t, y: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        pos, vel = y["pos"], y["vel"]
        angvel = y.get("angvel")
        n = pos.shape[0]

        # ---- particle pairs ----
        if mesh is not None:
            # shard_map body: local rows vs the full gathered state
            from jax import lax as _lax
            pos_f = _lax.all_gather(pos, axis_name, tiled=True)
            vel_f = _lax.all_gather(vel, axis_name, tiled=True)
            ang_f = (_lax.all_gather(angvel, axis_name, tiled=True)
                     if angvel is not None else None)
            N = pos_f.shape[0]
            rows = (_lax.axis_index(axis_name) * n
                    + jnp.arange(n, dtype=jnp.int32))
            mask = rows[:, None] != jnp.arange(N, dtype=jnp.int32)[None, :]
            npos = jnp.broadcast_to(pos_f[None, :, :], (n, N, 3))
            nvel = jnp.broadcast_to(vel_f[None, :, :], (n, N, 3))
            nang = (jnp.broadcast_to(ang_f[None, :, :], (n, N, 3))
                    if angvel is not None else None)
        elif neighbor == "dense":
            npos = jnp.broadcast_to(pos[None, :, :], (n, n, 3))
            nvel = jnp.broadcast_to(vel[None, :, :], (n, n, 3))
            nang = (jnp.broadcast_to(angvel[None, :, :], (n, n, 3))
                    if angvel is not None else None)
            mask = ~jnp.eye(n, dtype=bool)
        elif neighbor in ("cell_roll", "cell_lanes"):
            npos = None
        else:
            ids, mask = nbr_fn(pos)
            npos = pos[ids]
            nvel = vel[ids]
            nang = angvel[ids] if angvel is not None else None
        if npos is None:
            fn = (cell_lanes_accels if neighbor == "cell_lanes"
                  else cell_roll_accels)
            pacc, angacc = fn(pos, vel, angvel)
        else:
            pacc, angacc = pair_accels(pos, vel, angvel, npos, nvel, nang,
                                       mask)
        acc = gravity + pacc

        # ---- walls ----
        rel = pos[:, None, :] - walls_P[None, :, :]     # (n, walls, 3)
        wsurf = -jnp.sum(rel * walls_n[None, :, :], axis=-1) - cfg.r
        wmask = wsurf <= cfg.max_surf_dist
        WCF = jnp.where(wmask, collision_factor(wsurf), 0.0)
        wheading = jnp.sum(vel[:, None, :] * walls_n[None, :, :], axis=-1)
        acc = acc - jnp.sum(
            (WCF * rebound(wheading))[..., None] * walls_n[None, :, :], axis=1)

        if cfg.has_friction:
            wv_t = vel[:, None, :] - wheading[..., None] * walls_n[None, :, :]
            if angvel is not None:
                # wall normal points the SAME way as r here: +r * omega x n
                wsv = _cross(angvel[:, None, :],
                             jnp.broadcast_to(walls_n[None, :, :],
                                              (pos.shape[0],) + walls_n.shape))
                wv_t = wv_t + cfg.r * wsv
            wvt_mag = jnp.linalg.norm(wv_t, axis=-1) + cfg.zero
            wtdir = wv_t / wvt_mag[..., None]
            WFF = WCF * cfg.friction * friction_factor(wvt_mag)
            acc = acc - jnp.sum(WFF[..., None] * wtdir, axis=1)
            if angvel is not None:
                wtorque = _cross(jnp.broadcast_to(
                    walls_n[None, :, :],
                    (pos.shape[0],) + walls_n.shape), wtdir)
                angacc = angacc - jnp.sum(
                    (cfg.r * WFF / cfg.inertia)[..., None] * wtorque, axis=1)

        out = {"pos": vel, "vel": acc}
        if angvel is not None:
            out["angvel"] = (angacc if angacc is not None
                             else jnp.zeros_like(angvel))
        return out

    # drivers use this to validate occupancy at chunk boundaries
    # (advisor r4) — None for the dense strategy, which has no capacity
    rhs.neighbor_struct = neighbor_struct

    if mesh is None:
        return rhs

    if neighbor != "dense":
        raise ValueError("mesh sharding supports the dense neighbor "
                         "strategy (the cell list is single-device)")
    from functools import partial as _partial

    from jax import shard_map as _shard_map
    from jax.sharding import PartitionSpec as _P
    pspec = _P(axis_name, None)

    def rhs_sharded(t, y):
        specs = {k: pspec for k in y}
        impl = _partial(_shard_map, mesh=mesh,
                        in_specs=(_P(), specs), out_specs=specs,
                        check_vma=False)(rhs)
        return impl(jnp.asarray(t, dtype), y)

    rhs_sharded.neighbor_struct = None      # mesh path is dense-only
    return rhs_sharded
