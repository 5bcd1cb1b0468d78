#!/usr/bin/env python
"""Compare golden end-to-end runs against the reference's shipped logs.

Inputs: output dirs produced by scripts/run_golden_lr.sh (ours) and the
extracted reference case dirs (Cases-LR/...), whose intertrack.log files
carry per-snapshot cumulative step counts and wall times — the
deterministic cross-implementation oracle (SURVEY §4.2: step counts are
rank-count invariant).

Emits a markdown table block per case plus observable trajectories
(ice volume fraction / freezing-point statistic per snapshot, the
avg.sh / freezing_point_depression.sh pipelines) for our runs.

Usage:
  python scripts/compare_golden.py --ours /tmp/golden/LR-f64 \
      --ref /tmp/ref_cases/Cases-LR [--ours-f32 /tmp/golden/LR-f32] \
      [--out VALIDATION_LR.md]
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SNAP_RE = re.compile(
    r"Calculating snapshot (\d+) \.\.\. Done on [\d: -]+ - elapsed wall "
    r"time: ([\d:.]+), (\d+) R-K steps \((\d+) total\)")
FINAL_OURS = re.compile(r"Successful R-K steps: (\d+) of (\d+) total")
FINAL_REF_S = re.compile(r"Total successful R-K steps:\s+(\d+)")
FINAL_REF_T = re.compile(r"Total R-K steps: \s*(\d+)")
WALL_OURS = re.compile(r"Solver wall time: ([\d:.]+)")
WALL_REF = re.compile(r"Total wall time:\s+([\d:.]+)")


def hms_to_s(s: str) -> float:
    parts = [float(p) for p in s.split(":")]
    out = 0.0
    for p in parts:
        out = out * 60 + p
    return out


def parse_log(path: str):
    text = open(path).read()
    snaps = {int(m[0]): (hms_to_s(m[1]), int(m[2]), int(m[3]))
             for m in SNAP_RE.findall(text)}
    final = None
    m = FINAL_OURS.search(text)
    if m:
        final = (int(m[1]), int(m[2]))
    else:
        ms, mt = FINAL_REF_S.search(text), FINAL_REF_T.search(text)
        if ms and mt:
            final = (int(ms[1]), int(mt[1]))
    m = WALL_OURS.search(text) or WALL_REF.search(text)
    wall = hms_to_s(m[1]) if m else None
    return snaps, final, wall


def observables(case_dir: str):
    from porousfreezethaw.analysis import series_statistics
    try:
        return series_statistics(case_dir)
    except Exception:
        return None


def fmt_time(s):
    if s is None:
        return "-"
    h = int(s // 3600)
    m = int(s % 3600 // 60)
    return f"{h}:{m:02d}:{s % 60:05.2f}"


def compare_case(case: str, ref_dir: str, our_dirs):
    ref_log = os.path.join(ref_dir, case, "OUTPUT", "intertrack.log")
    if not os.path.exists(ref_log):
        return None
    ref_snaps, ref_final, ref_wall = parse_log(ref_log)
    if ref_final is None:
        return None  # incomplete reference run (e.g. GradP-smallsigma)
    lines = [f"### {case}", ""]
    hdr = ("| run | successful steps | total attempts | steps vs ref "
           "| solver wall | speedup |")
    lines += [hdr, "|---|---|---|---|---|---|"]
    lines.append(
        f"| reference (f64, CPU cluster) | {ref_final[0]:,} | "
        f"{ref_final[1]:,} | 1.000 | {fmt_time(ref_wall)} | 1.0x |")
    rows = {}
    for label, root in our_dirs:
        log = os.path.join(root, case, "intertrack.log")
        if not os.path.exists(log):
            continue
        snaps, final, wall = parse_log(log)
        if final is None:
            continue
        ratio = final[0] / ref_final[0]
        speed = (ref_wall / wall) if wall and ref_wall else None
        lines.append(
            f"| {label} | {final[0]:,} | {final[1]:,} | "
            f"{ratio:.3f} | {fmt_time(wall)} | "
            f"{speed:.1f}x |" if speed else
            f"| {label} | {final[0]:,} | {final[1]:,} | {ratio:.3f} | "
            f"{fmt_time(wall)} | - |")
        rows[label] = (snaps, final, wall)
    lines.append("")

    # per-snapshot step-count checkpoints (quartiles)
    if ref_snaps and rows:
        marks = [q for q in (25, 50, 75, 99) if q in ref_snaps]
        lines.append("Per-snapshot cumulative successful steps "
                     "(ours / reference):")
        lines.append("")
        lines.append("| snapshot | " + " | ".join(
            label for label, _ in our_dirs if label in rows) + " | reference |")
        lines.append("|---|" + "---|" * (len(rows) + 1))
        for q in marks:
            cells = []
            for label, _ in our_dirs:
                if label not in rows:
                    continue
                snaps = rows[label][0]
                cells.append(f"{snaps[q][1]:,}" if q in snaps else "-")
            lines.append(f"| {q} | " + " | ".join(cells)
                         + f" | {ref_snaps[q][1]:,} |")
        lines.append("")
    return "\n".join(lines), rows, (ref_snaps, ref_final, ref_wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--ours", action="append", default=[],
                    help="label=dir of a golden output root (repeatable)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--observables", action="store_true",
                    help="compute ice-fraction / freezing-point "
                         "trajectories for our runs (reads all snapshots)")
    args = ap.parse_args()

    our_dirs = []
    for spec in args.ours:
        label, _, root = spec.partition("=")
        our_dirs.append((label or root, root or label))

    cases = sorted(d for d in os.listdir(args.ref)
                   if os.path.isdir(os.path.join(args.ref, d))
                   and d.startswith("freeze-thaw"))
    blocks = []
    for case in cases:
        out = compare_case(case, args.ref, our_dirs)
        if out is None:
            continue
        block, rows, _ = out
        if args.observables:
            for label, root in our_dirs:
                stats = observables(os.path.join(root, case))
                if stats and stats["t"]:
                    block += (
                        f"\nObservables ({label}): final ice fraction "
                        f"{stats['ice_fraction'][-1]:.4f}, max "
                        f"{max(stats['ice_fraction']):.4f}; freezing-point "
                        f"statistic final {stats['freezing_point'][-1]:.3f}\n")
        blocks.append(block)

    text = "\n".join(blocks)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
