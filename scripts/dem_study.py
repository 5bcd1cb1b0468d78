#!/usr/bin/env python
"""DEM ensemble study — the Run_study.sh equivalent.

The reference runs a 10-member ensemble of the settling simulation and
evaluates the solids fraction eps_s of each resulting bed
(``apps/sphere-collider/Run_study.sh``).  Here each member runs with a
distinct RNG seed (the reference reseeds from the wall clock) and the
final eps_s statistics are printed.

Usage:  python scripts/dem_study.py [--runs 10] [--n 200] [--out DIR]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--variant", default="friction_angular")
    ap.add_argument("--final-time", type=float, default=8.0)
    ap.add_argument("--snapshots", type=int, default=40)
    ap.add_argument("--out", default="STUDY")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--eps-res", type=int, default=100)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from porousfreezethaw.analysis import eps_s
    from porousfreezethaw.apps.spheres import main as spheres_main
    from porousfreezethaw.io.csv_snaps import read_dem_snapshot
    import numpy as np

    results = []
    for run in range(1, args.runs + 1):
        out_dir = os.path.join(args.out, f"run_{run:02d}")
        t0 = time.time()
        code = spheres_main([
            "--variant", args.variant, "--n", str(args.n),
            "--final-time", str(args.final_time),
            "--snapshots", str(args.snapshots),
            "--seed", str(run), "--output", out_dir])
        if code != 0:
            print(f"run {run}: FAILED", file=sys.stderr)
            continue
        last = os.path.join(out_dir, f"snap_{args.snapshots:03d}.csv")
        cols = read_dem_snapshot(last)
        pos = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        val = eps_s(pos, r=0.1, res=args.eps_res)
        results.append(val)
        print(f"run {run}: eps_s = {val:.5f}  ({time.time()-t0:.0f}s)",
              file=sys.stderr)

    arr = np.asarray(results)
    print(json.dumps({
        "runs": len(results),
        "eps_s_mean": float(arr.mean()) if len(arr) else None,
        "eps_s_std": float(arr.std()) if len(arr) else None,
        "eps_s": [float(v) for v in arr],
    }))


if __name__ == "__main__":
    main()
