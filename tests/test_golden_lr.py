"""Golden regression vs the reference's shipped LR run (SURVEY §4.2).

The reference's step counts are its strongest cross-implementation
oracle: deterministic and rank-count invariant (intertrack.log of
``results/100_low-resolution/Cases-LR.tgz``).  This test replays the
shipped Temp case (``tests/golden/Params-LR-Temp``) on the real 50x50x100
grid to the first snapshot boundary (t=360 s) in f64 and pins the
successful / total attempt counts against the reference log's snapshot-1
line (1850 / 2256).

This is ~1 minute of CPU time (the heaviest test in the suite); the
full 10-hour-case comparison lives in VALIDATION.md (produced by
scripts/run_golden_lr.sh + scripts/compare_golden.py).  chip_smoke.py
repeats both snapshot-1 checks on the GPU.
"""

import os
import re

from porousfreezethaw.apps.intertrack import main

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "Params-LR-Temp")

# reference Cases-LR/freeze-thaw-10h-Temp/OUTPUT/intertrack.log, snapshot 1
REF_SUCCESSFUL, REF_TOTAL = 1850, 2256


def test_lr_temp_snapshot1_step_counts(tmp_path):
    text = open(GOLDEN).read()
    # run exactly one reference snapshot interval: with saved_files=100
    # the loop takes snapshots 0..99 spaced final_time/99 apart
    # (intertrack.c:2265-2271), so snapshot 1 falls at t = 36000/99 s
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    pfile = tmp_path / "Params"
    pfile.write_text(text)

    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = str(tmp_path)
    try:
        assert main([str(pfile)]) == 0
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old

    log = (tmp_path / "intertrack.log").read_text()
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    assert m, log[-2000:]
    successful, total = int(m[1]), int(m[2])

    # f64 tracks the reference within a few steps-per-thousand (an
    # earlier accelerator run measured 1809/2233 at snapshot 1 — 2.2%
    # low — converging to 0.06% relative by snapshot 25).  Allow 5%: snapshot 1 is the
    # worst point of the trajectory and a platform/XLA change shifting
    # FP summation order can move it by a few more per-mille; the full
    # golden runs in VALIDATION.md pin the tight end-of-run numbers.
    assert abs(successful - REF_SUCCESSFUL) <= 0.05 * REF_SUCCESSFUL
    assert abs(total - REF_TOTAL) <= 0.05 * REF_TOTAL


import pytest  # noqa: E402

GOLDEN_GRADP = os.path.join(HERE, "golden", "Params-LR-GradP")

# reference Cases-LR/freeze-thaw-10h-GradP/OUTPUT/intertrack.log, snap 1
GRADP_REF_SUCCESSFUL, GRADP_REF_TOTAL = 3560, 4322


@pytest.mark.slow
def test_lr_gradp_delta_snapshot1_step_counts():
    """GradP snapshot-1 golden guard for the increment-form (delta)
    numerics — the production f32 GradP path.  Drives the app's delta
    attempt (models/freezing/delta.py::XlaDeltaAttempt) through one
    reference snapshot interval in f32 with the EXACT reference
    step-control rule and pins the step counts: an error anywhere in the
    280 lines of hand-derived increment expansions shows up here as a
    step-count shift (a broken estimator either inflates attempts or
    accepts wrongly).  CPU reference value: 3647/4323 vs the reference
    log's 3560/4322 (~2-3 min of CPU)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from porousfreezethaw.config import parse_param_file
    from porousfreezethaw.core.grid import GridGeometry
    from porousfreezethaw.models.freezing import (
        FreezingParams, build_glass_field, build_initial_conditions,
        shift_temperature_origin)
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    from porousfreezethaw.models.freezing.glass import read_ball_positions
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    pf = parse_param_file(open(GOLDEN_GRADP).read(), env={"OUTPUT": "/tmp"})
    prm = FreezingParams.from_dict(pf.vars)
    geom = GridGeometry(pf.vars["L1"], pf.vars["L2"], pf.vars["L3"],
                        int(pf.vars["n1"]), int(pf.vars["n2"]),
                        int(pf.vars["n3"]))
    w0 = build_initial_conditions(geom, prm, pf.icond_formulas,
                                  dtype=np.float32)
    balls = read_ball_positions(
        os.path.join(os.path.dirname(HERE), "data",
                     "spheres_positions.txt"), prm)
    w0[2] = build_glass_field(geom, prm, balls, w0[2])
    w0[0] -= prm.u_star
    att = XlaDeltaAttempt(geom, shift_temperature_origin(prm, prm.u_star), 0)
    params = MersonParams(delta=pf.vars["delta"], h_min=pf.vars["tau_min"],
                          handle_nan=True, max_steps=1024)
    state = merson_init(jnp.asarray(w0), 0.0, pf.vars["tau"])
    solve = jax.jit(lambda st: merson_solve(
        lambda t, y: y, st, 36000.0 / 99, params, attempt_fn=att))
    while True:
        state, status = solve(state)
        if int(status) != -7:  # MAX_STEPS -> continue next chunk
            break
    assert int(status) == 0
    successful, total = int(state.steps), int(state.steps_total)
    # the delta estimator has no f32 noise floor, so the counts sit in
    # the f64 band: measured 3647/4323 (2.4% above the reference's
    # successful count, attempts within 1).  5% guards the algebra while
    # tolerating FP-summation-order shifts across XLA versions.
    assert abs(successful - GRADP_REF_SUCCESSFUL) <= \
        0.05 * GRADP_REF_SUCCESSFUL
    assert abs(total - GRADP_REF_TOTAL) <= 0.05 * GRADP_REF_TOTAL
