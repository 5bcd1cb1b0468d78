#!/bin/bash
# Golden-run validation: execute the reference's shipped LR Params files
# (extracted from results/100_low-resolution/Cases-LR.tgz) end-to-end and
# leave logs for comparison against the reference intertrack.log step
# counts and observables.  Usage:
#   run_golden_lr.sh <cases_dir> <out_root> [precision] [extra args...]
# where <cases_dir> contains freeze-thaw-10h-*/Params.
set -u
CASES=${1:?cases dir}
OUT=${2:?output root}
PREC=${3:-f64}
shift 3 || true
cd "$(dirname "$0")/.."
for case in freeze-thaw-10h-Temp freeze-thaw-10h-SigmaP1-P \
            freeze-thaw-10h-SigmaP1-P-smallsigma freeze-thaw-10h-GradP; do
  dir="$OUT/$case"
  mkdir -p "$dir"
  if [ -f "$dir/DONE" ]; then echo "skip $case (done)"; continue; fi
  echo "=== $case ($PREC) start: $(date)"
  OUTPUT=$dir python -m porousfreezethaw.apps.intertrack \
    "$CASES/$case/Params" --precision "$PREC" "$@" \
    > "$dir/stdout.txt" 2>&1 && touch "$dir/DONE"
  echo "=== $case end: $(date) rc=$?"
  tail -5 "$dir/intertrack.log" 2>/dev/null
done
