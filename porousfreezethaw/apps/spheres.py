"""The spheres DEM settling simulator application.

Equivalent of the reference ``apps/sphere-collider`` family
(``spheres_friction_angular.c:494-626``): simulate spherical particles
falling into a vessel under a soft contact model, writing CSV snapshots.
The reference selects one of four source variants by symlink and compiles
constants in; here everything is a CLI flag with the reference defaults.

CLI example::

    python -m porousfreezethaw.apps.spheres --variant friction_angular \
        --n 200 --snapshots 400 --output OUTPUT

Snapshot numbering starts from 1 (MATLAB compatibility,
spheres_friction_angular.c:611-613).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..core.runtime import enable_compile_cache
from ..io.csv_snaps import snapshot_path, write_dem_snapshot
from ..io.rklog import format_time
from ..models.dem import (
    DEMConfig, icond_2spheres, icond_dense, icond_sparse, make_dem_rhs,
    write_final_positions)
from ..solvers.merson import MersonParams, merson_init, merson_solve

ICONDS = {"dense": icond_dense, "sparse": icond_sparse,
          "2spheres": icond_2spheres}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="spheres", description="DEM sphere settling simulator")
    ap.add_argument("--variant", default="friction_angular",
                    choices=["basic", "basic_WB", "friction", "friction_angular"])
    ap.add_argument("--icond", default="dense", choices=list(ICONDS))
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--r", type=float, default=0.1)
    ap.add_argument("--final-time", type=float, default=8.0)
    ap.add_argument("--snapshots", type=int, default=400)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--ht", type=float, default=0.1)
    ap.add_argument("--ht-min", type=float, default=1e-9)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--output", default="OUTPUT")
    ap.add_argument("--neighbor", choices=["dense", "cell_list",
                                           "cell_roll", "cell_lanes"],
                    default="dense",
                    help="pair search: exact masked n x n (reference "
                         "semantics) or a spatial cell structure for "
                         "large n")
    ap.add_argument("--cell-capacity", type=int, default=16,
                    help="max particles per cell for the cell "
                         "strategies; occupancy is checked after every "
                         "solver call and overflow aborts loudly "
                         "(the kernels also NaN-poison on overflow)")
    ap.add_argument("--device-buffer", type=int, default=0, metavar="B",
                    help="record B snapshot states on device per solver "
                         "call (lax.scan over targets) and fetch them "
                         "in one transfer, instead of one host round "
                         "trip per snapshot")
    ap.add_argument("--final-positions", default=None, metavar="PATH",
                    help="write resting sphere centers after the run "
                         "(extract_final_positions.m contract; the "
                         "freezing app's ball_positions_file input)")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f64")
    ap.add_argument("--platform", default=None,
                    help="run on this jax platform only (e.g. 'cpu' for "
                         "tests); default: the platform JAX selects")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="shard particles over a device mesh (e.g. 'p' = "
                         "all devices, 'p4'); results are mesh-size "
                         "invariant — a capability the reference DEM "
                         "lacks (MPI 'not supported', "
                         "spheres_friction_angular.c:614-616)")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    # x64 always on: --precision selects the state dtype; the Merson
    # controller scalars must be f64 (f32 time accumulation stalls once
    # the step drops below ulp(t)/2 — the DEM's stiff contacts reach
    # h ~ 1e-6 at t ~ 8)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    cfg = DEMConfig(variant=args.variant, n=args.n, r=args.r,
                    T=args.final_time, ht=args.ht, ht_min=args.ht_min,
                    delta=args.delta, snapshots=args.snapshots)
    if args.icond == "2spheres":
        # the 2-sphere test forces n=2 and zero gravity
        # (spheres_friction_angular.c:398-401)
        cfg = DEMConfig(variant=args.variant, n=2, r=args.r,
                        T=args.final_time, ht=args.ht, ht_min=args.ht_min,
                        delta=args.delta, snapshots=args.snapshots,
                        gravity=(0.0, 0.0, 0.0))
        y0, color = icond_2spheres(cfg)
    else:
        y0, color = ICONDS[args.icond](cfg, seed=args.seed)

    print("Initializing...")
    os.makedirs(args.output, exist_ok=True)
    dtype = jnp.float32 if args.precision == "f32" else jnp.float64
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                          handle_nan=dtype == jnp.float32)
    y_dev = {k: jnp.asarray(v, dtype) for k, v in y0.items()}
    mesh = None
    if args.mesh:
        from ..parallel.sharding import make_mesh, shard_dem_state
        mesh = make_mesh(args.mesh)
        y_dev = shard_dem_state(y_dev, mesh)
        print(f"Particles sharded over mesh "
              f"{dict(zip(mesh.axis_names, mesh.devices.shape))}")
    rhs = make_dem_rhs(cfg, dtype=dtype, neighbor=args.neighbor, mesh=mesh,
                       cell_capacity=args.cell_capacity)
    state = merson_init(y_dev, 0.0, cfg.ht)
    solve = jax.jit(lambda st, ft: merson_solve(rhs, st, ft, params))

    def check_capacity(st):
        # guarded capacity: densification past the cell capacity would
        # drop pairs (the kernel NaN-poisons on overflow; this names the
        # cause before the solver's NaN backoff grinds h into the floor)
        if rhs.neighbor_struct is None:
            return
        occ = rhs.neighbor_struct.cell_occupancy(st.y["pos"])
        if occ > rhs.neighbor_struct.capacity:
            raise SystemExit(
                f"cell occupancy {occ} exceeds capacity "
                f"{rhs.neighbor_struct.capacity} at t="
                f"{float(st.t):.4f}: rerun with a larger "
                f"--cell-capacity or --neighbor dense")

    def save_snap(snap, y_host, steps, steps_total, elapsed):
        print(f"Done. Elapsed wall time: {format_time(elapsed)}, "
              f"{steps} R-K steps ({steps_total} total)")
        print(f"Saving snapshot {snap + 1} of {cfg.snapshots}.")
        write_dem_snapshot(snapshot_path(args.output, snap + 1),
                           y_host, color, angular=cfg.angular)

    def t_target(snap):
        return (cfg.T / (cfg.snapshots - 1)) * snap

    def solve_one(snap, elapsed):
        nonlocal state
        print(f"Solving until t={t_target(snap):f} ....", end="",
              flush=True)
        t0 = time.time()
        state, status = solve(state, t_target(snap))
        check_capacity(state)
        if int(status) != 0:
            print(f"\nsolver failed with status {int(status)}")
            raise SystemExit(1)
        elapsed += time.time() - t0
        save_snap(snap, {k: np.asarray(v) for k, v in state.y.items()},
                  int(state.steps), int(state.steps_total), elapsed)
        return elapsed

    start = time.time()
    elapsed = 0.0
    if args.device_buffer > 0:
        # device-buffered mode: lax.scan over B snapshot targets inside
        # ONE dispatched program — merson_solve's continuation-h
        # contract threads through the scan carry exactly as it does
        # through the host loop, so step counts are identical; only the
        # host round trips collapse (B snapshots per dispatch, one
        # stacked fetch).
        B = args.device_buffer

        @jax.jit
        def solve_batch(st, targets):
            def step_fn(s, tgt):
                s2, stat = merson_solve(rhs, s, tgt, params)
                return s2, (s2.y, s2.steps, s2.steps_total, stat)
            return jax.lax.scan(step_fn, st, targets)

        snap = 0
        while snap < cfg.snapshots:
            nb = min(B, cfg.snapshots - snap)
            # fixed-length targets (one compile): pad by repeating the
            # last target — a solve to the current t is a no-op
            tgts = [t_target(snap + i) for i in range(nb)]
            tgts += [tgts[-1]] * (B - nb)
            t0 = time.time()
            state, (ys, steps_a, totals_a, stats) = solve_batch(
                state, jnp.asarray(tgts, jnp.float64))
            stats = np.asarray(stats)
            check_capacity(state)
            if np.any(stats[:nb] != 0):
                print(f"\nsolver failed with status "
                      f"{int(stats[:nb][stats[:nb] != 0][0])}")
                raise SystemExit(1)
            elapsed += time.time() - t0
            ys = {k: np.asarray(v) for k, v in ys.items()}
            steps_a = np.asarray(steps_a)
            totals_a = np.asarray(totals_a)
            for i in range(nb):
                print(f"Solving until t={tgts[i]:f} ....", end="")
                save_snap(snap + i, {k: v[i] for k, v in ys.items()},
                          int(steps_a[i]), int(totals_a[i]), elapsed)
            snap += nb
    else:
        for snap in range(cfg.snapshots):
            elapsed = solve_one(snap, elapsed)

    if args.final_positions:
        write_final_positions(args.final_positions,
                              {k: np.asarray(v) for k, v in state.y.items()})
        print(f"Final positions written to: {args.final_positions}")

    print(f"\nSimulation completed in: {format_time(time.time() - start)}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
