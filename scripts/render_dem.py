#!/usr/bin/env python
"""Render DEM snapshots to images — the MATLAB twin's sphere rendering +
PNG export analog (``spheres.m:91-113``).

Draws an orthographic projection of the spheres (painter's algorithm along
the view axis, z-colored like the reference's color column) into a PPM via
the framework's own exporter.

Usage:  python scripts/render_dem.py OUTPUT/snap_400.csv [-o out.ppm]
        python scripts/render_dem.py OUTPUT --all   # render every snapshot
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from porousfreezethaw.io.csv_snaps import read_dem_snapshot  # noqa: E402
from porousfreezethaw.io.exporters import ppm_export  # noqa: E402


def render(path: str, out: str, r: float = 0.1, size: int = 400,
           view: str = "front") -> None:
    cols = read_dem_snapshot(path)
    pos = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    color = cols["color"]

    # view plane: front = (x, z); top = (x, y)
    if view == "front":
        u, v, depth = pos[:, 0], pos[:, 2], pos[:, 1]
        vmax = max(1.0, pos[:, 2].max() + r)
    else:
        u, v, depth = pos[:, 0], pos[:, 1], pos[:, 2]
        vmax = 1.0
    w_px = size
    h_px = int(size * vmax)
    scale = size  # pixels per unit length

    R = np.zeros((h_px, w_px))
    G = np.zeros((h_px, w_px))
    B = np.full((h_px, w_px), 0.12)  # background

    cmin, cmax = float(color.min()), float(max(color.max(), color.min() + 1e-9))
    order = np.argsort(depth)[::-1]  # far to near
    yy, xx = np.mgrid[0:h_px, 0:w_px]
    for i in order:
        cu, cv = u[i] * scale, v[i] * scale
        rr = r * scale
        x0, x1 = max(0, int(cu - rr) - 1), min(w_px, int(cu + rr) + 2)
        y0, y1 = max(0, int(cv - rr) - 1), min(h_px, int(cv + rr) + 2)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = xx[y0:y1, x0:x1] - cu
        dy = yy[y0:y1, x0:x1] - cv
        d2 = dx * dx + dy * dy
        mask = d2 <= rr * rr
        # simple sphere shading: brightness from the surface normal
        shade = np.sqrt(np.clip(1.0 - d2 / (rr * rr), 0.0, 1.0))
        t = (color[i] - cmin) / (cmax - cmin)
        for img, base in ((R, 0.2 + 0.8 * t), (G, 0.4), (B, 1.0 - 0.8 * t)):
            region = img[y0:y1, x0:x1]
            region[mask] = (0.25 + 0.75 * shade[mask]) * base

    # image rows top-down: flip v
    ppm_export(out, R[::-1], G[::-1], B[::-1], maxcolor=255,
               comment=os.path.basename(path))
    print(f"rendered {path} -> {out} ({w_px}x{h_px})", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="snapshot CSV or a directory with --all")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--r", type=float, default=0.1)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--view", choices=["front", "top"], default="front")
    args = ap.parse_args()

    if args.all:
        for path in sorted(glob.glob(os.path.join(args.input, "snap_*.csv"))):
            render(path, path.replace(".csv", f"_{args.view}.ppm"),
                   r=args.r, size=args.size, view=args.view)
    else:
        out = args.output or args.input.replace(".csv", f"_{args.view}.ppm")
        render(args.input, out, r=args.r, size=args.size, view=args.view)


if __name__ == "__main__":
    main()
