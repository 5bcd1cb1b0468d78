#!/usr/bin/env python
"""Device-scaling study — the Run_study_CPU.sh equivalent.

The reference sweeps 1..32 OpenMP threads over the DEM workload; this
sweeps device-mesh sizes over the freezing solve on the virtual CPU mesh
or on several GPUs.  For each mesh size it
times a fixed number of attempted Merson steps and reports cell-RHS-evals/s
and parallel efficiency vs 1 device.

Usage:
  python scripts/scaling_study.py --platform cpu --grid-nodes 64 \
      --meshes 1,2,4,8 [--weak] [--explicit-halo]

NOTE: on the virtual CPU mesh the multi-device rows validate the
*protocol* (sharded execution, halo collectives, invariant step counts) —
virtual devices emulate collectives through the host, so their absolute
throughput and efficiency are meaningless.  Real scaling numbers require
several GPUs, where the same script runs unchanged.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid-nodes", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--meshes", default="1,2,4,8",
                    help="comma-separated z-mesh sizes")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--explicit-halo", action="store_true",
                    help="use the shard_map+ppermute path instead of GSPMD")
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling: grow n3 with the device count "
                         "(constant per-device work; the BASELINE.md "
                         "north-star protocol)")
    args = ap.parse_args()

    if args.platform == "cpu" and "host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        need = max(int(m) for m in args.meshes.split(","))
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={need}").strip()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from porousfreezethaw.cases import freezing_params_text
    from porousfreezethaw.config import parse_param_file
    from porousfreezethaw.core.grid import GridGeometry
    from porousfreezethaw.models.freezing import (
        FreezingParams, build_initial_conditions, make_rhs,
        shift_temperature_origin)
    from porousfreezethaw.parallel.halo import make_shard_map_rhs, shard_spec
    from porousfreezethaw.parallel.sharding import (
        make_mesh, shard_freezing_state)
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    pf = parse_param_file(freezing_params_text(grid_nodes=args.grid_nodes),
                          env={"OUTPUT": "."})
    prm0 = FreezingParams.from_dict(pf.vars)
    prm = shift_temperature_origin(prm0, prm0.u_star)

    def make_case(nz):
        # weak scaling stretches the domain and grid along z so each
        # device keeps a constant block (the reference cannot do this
        # without regenerating its input decks)
        mult = nz if args.weak else 1
        g = GridGeometry(pf.vars["L1"], pf.vars["L2"],
                         pf.vars["L3"] * mult,
                         int(pf.vars["n1"]), int(pf.vars["n2"]),
                         int(pf.vars["n3"]) * mult)
        w = build_initial_conditions(g, prm0, pf.icond_formulas,
                                     dtype=np.float32)
        w[0] -= prm0.u_star
        return g, w

    params = MersonParams(delta=pf.vars["delta"], h_min=pf.vars["tau_min"],
                          max_steps=args.steps, handle_nan=True)
    rows = []
    for nz in [int(m) for m in args.meshes.split(",")]:
        geom, w0 = make_case(nz)
        if nz == 1:
            rhs = make_rhs(geom, prm, 0)
            w = jnp.asarray(w0, jnp.float32)
        else:
            mesh = make_mesh(f"z{nz}")
            if args.explicit_halo:
                rhs = make_shard_map_rhs(geom, prm, 0, mesh)
                w = jax.device_put(jnp.asarray(w0, jnp.float32),
                                   shard_spec(mesh))
            else:
                rhs = make_rhs(geom, prm, 0)
                w = shard_freezing_state(jnp.asarray(w0, jnp.float32), mesh)
        solve = jax.jit(lambda st: merson_solve(rhs, st, 1e9, params))
        state = merson_init(w, 0.0, 1e-4)
        state, _ = solve(state)                   # compile + warmup
        n0 = int(state.steps_total)
        t0 = time.time()
        state, _ = solve(state)
        wall = time.time() - t0
        done = int(state.steps_total) - n0
        evals = 5.0 * geom.num_cells * done / wall
        rows.append({"devices": nz, "cell_rhs_evals_per_s": evals,
                     "wall_s": wall, "attempts": done})
        print(f"z={nz}: {evals:.3e} evals/s ({wall:.2f}s)", file=sys.stderr)

    base = rows[0]["cell_rhs_evals_per_s"]
    for r in rows:
        # strong: ideal = base*devices at fixed size; weak: per-device
        # throughput should stay constant as the domain grows
        r["efficiency"] = r["cell_rhs_evals_per_s"] / (base * r["devices"])
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
