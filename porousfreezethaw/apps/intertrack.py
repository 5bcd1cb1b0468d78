"""The intertrack freezing/thawing simulator application.

Drop-in equivalent of the reference driver
(``apps/intertrack-hybrid-S-freezing/intertrack.c``): reads the same Params
files, produces the same NetCDF snapshot series with the same filenames,
attribute contract and log structure, and supports the same feature set —
formula and dataset initial conditions, ``continue_series`` resume, batch
sweeps with mnemonics and ``continue_if``, the RK debug log, on-demand
snapshots via a trigger file, and post-processing script execution.

CLI:  ``python -m porousfreezethaw.apps.intertrack param_file
[master_rank] [ubound_list]``  (``intertrack.c:1304``; master_rank is
accepted for command-line compatibility and ignored — SPMD has no master
rank).

Where the reference spreads work over MPI ranks x OpenMP threads, this app
jits the whole adaptive solve between snapshots onto the available device
mesh (``--mesh z`` to shard the grid over devices).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..config.params import (
    ParamError, ParamFile, batch_iterations, loop_suffix, parse_param_file)
from ..core.grid import GridGeometry
from ..core.runtime import enable_compile_cache
from ..io.csv_snaps import snapshot_path  # noqa: F401 (spheres uses it)
from ..io.rklog import RKDebugLog, RunLog, format_date, format_time
from ..io.snapshots import load_checkpoint, write_snapshot
from ..models.freezing.glass import build_glass_field, read_ball_positions
from ..models.freezing.icond import build_initial_conditions
from ..models.freezing.parameters import FreezingParams, PARAM_INFO, VARIABLES
from ..solvers.merson import (
    INTERRUPTED, MersonParams, MersonState, merson_init, merson_solve)

DEFAULT_BALL_POSITIONS = "data/spheres_positions.txt"  # equation.c:35


class IntertrackError(RuntimeError):
    pass


def _unshift(fields: np.ndarray, u_shift: float) -> np.ndarray:
    """Restore absolute temperatures before writing a snapshot."""
    if not u_shift:
        return fields
    out = np.array(fields, copy=True)
    out[0] += u_shift
    return out


def _require(pf: ParamFile, name: str) -> float:
    try:
        return pf.get(name)
    except ParamError:
        raise IntertrackError(
            f"Variable check error: {name} is not defined (see the log)")


def run_iteration(
    pf: ParamFile,
    log: RunLog,
    *,
    loop_iter: int = 0,
    loop_values: Optional[List[int]] = None,
    loop_ubounds: Optional[List[int]] = None,
    dtype=np.float64,
    mesh_axes: Optional[str] = None,
    debug_log: Optional[RKDebugLog] = None,
) -> Dict[str, float]:
    """One full simulation (one batch iteration).  Returns run stats."""
    import jax
    import jax.numpy as jnp

    # ---------- parameters setting (intertrack.c:1489-1577) ----------
    log("\nSetting geometry parameters:\n")
    L1 = _require(pf, "L1")
    log("Domain base width: %g\n", L1)
    L2 = _require(pf, "L2")
    log("Domain base height: %g\n", L2)
    L3 = _require(pf, "L3")
    log("Domain depth: %g\n", L3)

    log("\nSetting model parameters:\n")
    values: Dict[str, float] = {}
    for name, desc in PARAM_INFO:
        if name is None:
            log("\n--- %s ---\n\n", desc)
            continue
        values[name] = _require(pf, name)
        log("%-70s : %-23s = %g\n", desc, name, values[name])
    params = FreezingParams.from_dict(values)

    log("\nSetting numerical solution parameters:\n")
    calc_mode = pf.get_int("calc_mode", 0)
    log("Calculation mode: %d\n", calc_mode)
    n1 = pf.get_int("n1", 0)
    n2 = pf.get_int("n2", 0)
    total_n3 = pf.get_int("n3", 0)
    log("Grid X inner nodes: %d\nGrid Y inner nodes: %d\nGrid Z inner nodes: %d\n",
        n1, n2, total_n3)

    total_snapshots = pf.get_int("saved_files")
    log("Number of snapshots (the zeroth snapshot is the init. cond.): %d\n",
        total_snapshots)
    tau = pf.get("tau")
    log("Initial time step: %g\n", tau)
    final_time = pf.get("final_time")
    log("Final time : %g\n", final_time)
    delta = pf.get("delta")
    log("Runge-Kutta-Merson solver tolerance (delta) : %g\n", delta)
    tau_min = pf.get("tau_min", 0.0)
    log("Time step lower bound for RKM iteration to be controlled by delta : %g\n",
        tau_min)
    comment = pf.setting("comment")
    log("Comment: %s\n", comment)

    icond_file = pf.setting("icond_file")
    continue_series = pf.flag("continue_series")
    starting_time = 0.0
    starting_snapshot = 0

    # ---------- initial conditions ----------
    if icond_file:
        log("\nChecking availability of the initial conditions input dataset ...\n")
        ck = load_checkpoint(icond_file)
        ck_n1, ck_n2, ck_n3 = ck.geom_dims
        for label, have, stored in (("n1", n1, ck_n1), ("n2", n2, ck_n2),
                                    ("n3", total_n3, ck_n3)):
            if have == 0:
                log("%s=%d(STORED) ", label, stored)
            elif have != stored:
                raise IntertrackError(
                    f"{label} has been previously defined as {have}, dataset "
                    f"has {stored}")
            else:
                log("%s=%d(OK) ", label, have)
        log("\n")
        n1, n2, total_n3 = ck_n1, ck_n2, ck_n3
        geom = GridGeometry(L1, L2, L3, n1, n2, total_n3)
        w0 = ck.fields
        if continue_series:
            starting_snapshot = ck.snapshot
            total_snapshots = ck.total_snapshots
            starting_time = ck.t
            final_time = ck.final_time
            tau = ck.tau
            log("\nSeries continuation mode has been requested.\n"
                "Starting snapshot: %d\nStarting time: %g\n"
                "Initial time step override: %g\nFinal time override: %g\n"
                "Total number of snapshots override: %d\n",
                starting_snapshot, starting_time, tau, final_time,
                total_snapshots)
    else:
        if continue_series:
            log("Warning: continue_series is only meaningful when the "
                "initial conditions are loaded from file.\n")
        if n1 < 1 or n2 < 1 or total_n3 < 1:
            raise IntertrackError("The grid dimensions must be at least 1")
        geom = GridGeometry(L1, L2, L3, n1, n2, total_n3)
        loop_env = {f"i{q+1}": v for q, v in enumerate(loop_values or [])}
        w0 = build_initial_conditions(geom, params, pf.icond_formulas,
                                      loop_vars=loop_env, dtype=dtype)

    # ---------- PrecalculateData: noise + glass balls (equation.c:439-558) ----
    noise = None
    if params.u_noise_amp != 0.0:
        from ..models.freezing.equation import make_noise_field
        noise = make_noise_field(geom, params, jax.random.PRNGKey(loop_iter),
                                 dtype=dtype)

    ball_file = pf.setting("ball_positions_file", DEFAULT_BALL_POSITIONS)
    try:
        balls = read_ball_positions(ball_file, params)
        log("Successfully read coordinates of %d glass balls.\n\n", len(balls))
    except OSError:
        log("ERROR: Could not read glass balls coordinates from: %s\n", ball_file)
        raise IntertrackError("Reading glass balls positions failed.")
    w0 = np.asarray(w0, dtype=dtype)
    w0[2] = build_glass_field(geom, params, balls, w0[2])

    models = ["Phase field / GradP", "Phase field / SigmaP1-P",
              "Heat equation with latent heat release focusing"]
    if calc_mode not in (0, 1, 2, 10, 11):
        raise IntertrackError(f"invalid calc_mode value {calc_mode}")
    log("\nSolidification model: %s\n\n", models[calc_mode % 10])

    # ---------- solver setup ----------
    from ..models.freezing.equation import make_rhs
    from ..models.freezing.parameters import shift_temperature_origin
    from ..parallel.sharding import shard_freezing_state, make_mesh

    # f32 runs store u - u_star: exact reformulation that drops the error
    # estimator's f32 rounding floor ~16x (see shift_temperature_origin)
    u_shift = params.u_star if np.dtype(dtype) == np.float32 else 0.0
    solver_params = (shift_temperature_origin(params, u_shift)
                     if u_shift else params)
    if u_shift:
        w0[0] -= u_shift
        log("Temperature origin shifted by u_star for f32 conditioning.\n")

    rhs = make_rhs(geom, solver_params, calc_mode, noise=noise)
    w_dev = jnp.asarray(w0)
    if pf.vars.get("compensated_commit", 0.0):
        raise IntertrackError(
            "compensated_commit has been removed: the compensated f32 "
            "commit did not reduce the f32 step inflation (PERF.md); "
            "drop the variable from the Params file")
    # The increment-form (delta) attempt is the f32 default for all
    # models: its exact f(w+d)-f(w) stages remove the f32 stage-state
    # rounding floor from the error estimator (models/freezing/delta.py),
    # so the controller follows the reference f64 step sizes under the
    # EXACT reference step-control rule.  Measured on the shipped LR
    # cases (VALIDATION.md): step inflation 1.02-1.03x against 1.05-1.07x
    # for the classic stages with the escape below; at MR GradP the
    # classic f32 path never finished the thaw.  `increment_form 0`
    # selects the classic stages and their noise-floor escape.  The
    # increment form has no noise term, so a noisy run stays classic.
    attempt_fn = None
    if (np.dtype(dtype) == np.float32 and noise is None
            and pf.vars.get("increment_form", 1.0)):
        from ..models.freezing.delta import XlaDeltaAttempt
        attempt_fn = XlaDeltaAttempt(geom, solver_params, calc_mode)
        log("Increment-form (delta) attempt: ON\n")
    if mesh_axes:
        mesh = make_mesh(mesh_axes)
        log("Device mesh: %s\n", dict(zip(mesh.axis_names, mesh.devices.shape)))
        w_dev = shard_freezing_state(w_dev, mesh)

    state = merson_init(w_dev, starting_time, tau)
    # f32 classic runs enable the noise-floor escape: the f32 stage-state
    # rounding puts an h-independent floor under the Merson error
    # estimate that can pin h at the controller's growth fixed point
    # (eps = 0.328 delta); f64 and the increment form, whose estimator
    # has no such floor, keep the exact reference rule.  Overridable as
    # a Params variable (`accept_growth_min 0` restores the exact rule).
    default_growth = (1.05 if np.dtype(dtype) == np.float32
                      and attempt_fn is None else 0.0)
    growth_min = float(pf.vars.get("accept_growth_min", default_growth))
    # NaN/Inf backoff (the solver's opt-in recovery, RK_Asolver.c:96-131;
    # the reference ships it commented out, intertrack.c:2193, because in
    # f64 the shipped tau=1 cold start cannot overflow).  In f32 the
    # GradP stage cascade DOES overflow at tau=1: eps=inf drives the
    # growth factor to 0 and h spins at exactly 0 forever (the reference
    # would loop forever too), and an on-device loop never returns.
    # Backoff shrinks h tenfold per attempt until finite, which is the
    # reference-native escape.  Overridable as a Params variable.
    default_nan = np.dtype(dtype) == np.float32
    handle_nan = bool(pf.vars.get("handle_nan", default_nan))
    mparams = MersonParams(delta=delta, h_min=tau_min,
                           accept_growth_min=growth_min,
                           handle_nan=handle_nan)
    if growth_min:
        log("f32 step-control: accept-side minimum h growth %.2f\n",
            growth_min)

    # service facility: RK debug log + snapshot trigger (intertrack.c:1072-1116)
    trigger_file = pf.setting("snapshot_trigger")
    want_service = debug_log is not None or bool(trigger_file)

    if want_service and mesh_axes:
        # A host callback cannot be partitioned over a mesh, so the
        # sharded service path solves in chunks of PFT_SERVICE_CHUNK
        # attempts: the (t, h) trace is recorded on device and drained
        # between chunks.  Trigger-file latency becomes one chunk instead
        # of one step — the only observable difference from the
        # reference's per-step callback.
        import dataclasses as _dc
        from ..solvers import merson as _m
        try:
            chunk = int(os.environ.get("PFT_SERVICE_CHUNK", "1024"))
        except ValueError:
            raise SystemExit(
                "PFT_SERVICE_CHUNK must be a positive integer, got "
                f"{os.environ['PFT_SERVICE_CHUNK']!r}")
        if chunk <= 0:
            raise SystemExit(
                f"PFT_SERVICE_CHUNK must be a positive integer, got {chunk}")
        cparams = _dc.replace(mparams, max_steps=chunk, record_trace=chunk)
        solve_chunk = jax.jit(
            lambda st, ft: merson_solve(rhs, st, ft, cparams,
                                        attempt_fn=attempt_fn))

        def solve(state, ft):
            while True:
                prev_steps = int(state.steps)
                state, status, (tt, hh) = solve_chunk(state, ft)
                status = int(status)
                n_new = int(state.steps) - prev_steps
                if debug_log is not None and n_new:
                    tt_h = np.asarray(tt)
                    hh_h = np.asarray(hh)
                    for i in range(n_new):
                        debug_log.log_step(float(tt_h[i]), float(hh_h[i]),
                                           prev_steps + i + 1)
                if trigger_file and os.path.exists(trigger_file):
                    return state, INTERRUPTED
                if status == _m.MAX_STEPS:
                    continue
                return state, status
    else:
        service = None
        if want_service:
            def service(t, h, steps):
                if debug_log is not None:
                    debug_log.log_step(t, h, steps)
                if trigger_file and os.path.exists(trigger_file):
                    return 1
                return 0

        solve = jax.jit(
            lambda st, ft: merson_solve(rhs, st, ft, mparams,
                                        service_callback=service,
                                        attempt_fn=attempt_fn))

    # ---------- output naming (incl. batch dirs, intertrack.c:1437-1484) ----
    out_file = pf.setting("out_file")
    if not out_file:
        raise IntertrackError("Output file not specified.")
    suffix = pf.setting("out_file_suffix")
    if loop_ubounds:
        sfx = loop_suffix(loop_values, loop_ubounds, pf.mnemonics)
        out_dir = out_file + sfx
        os.makedirs(out_dir, exist_ok=True)
        base_name = os.path.basename(out_file)
        def fname(snap, on_demand=None):
            mid = f".{snap:03d}" + ("" if on_demand is None else f".{on_demand:03d}")
            return f"{out_dir}/{base_name}{mid}{sfx}{suffix}"
    else:
        def fname(snap, on_demand=None):
            mid = f".{snap:03d}" + ("" if on_demand is None else f".{on_demand:03d}")
            return f"{out_file}{mid}{suffix}"

    skip_icond = pf.flag("skip_icond")

    # ---------- snapshot loop (intertrack.c:2265-2560) ----------
    log("\nStarting the simulation on: %s\n\n", format_date())
    wall_start = time.time()
    elapsed_solver = 0.0
    on_demand_counter = 0
    snapshot = starting_snapshot
    while snapshot < total_snapshots:
        log("Calculating snapshot %d ... ", snapshot)
        is_on_demand = False
        t0 = time.time()
        if snapshot > starting_snapshot:
            next_snapt = starting_time + (
                (final_time - starting_time) * (snapshot - starting_snapshot)
                / (total_snapshots - 1 - starting_snapshot))
            if debug_log is not None:
                debug_log.set_snapshot(snapshot, next_snapt)
            state, status = solve(state, next_snapt)
            status = int(status)
            if status == INTERRUPTED:
                is_on_demand = True
            elif status != 0:
                raise IntertrackError(f"solver failed with status {status}")
        elapsed_solver += time.time() - t0

        steps = int(state.steps)
        steps_total = int(state.steps_total)
        if is_on_demand:
            log("On-demand snapshot triggered on %s - elapsed wall time: %s, "
                "%d R-K steps, t=%g\n", format_date(),
                format_time(elapsed_solver), steps, float(state.t))
            filename = fname(snapshot - 1, on_demand_counter)
            on_demand_counter += 1
        else:
            log("Done on %s - elapsed wall time: %s, %d R-K steps (%d total)\n",
                format_date(), format_time(elapsed_solver), steps, steps_total)
            filename = fname(snapshot)
        log("Saving file: %s ... [", filename)

        if snapshot == starting_snapshot and skip_icond and not is_on_demand:
            log("SKIPPED]\n")
            snapshot += 1
            continue
        if not is_on_demand:
            on_demand_counter = 0

        snap_kw = dict(
            calc_mode=calc_mode, delta=delta, tau=float(state.h),
            t=float(state.t), final_time=final_time, snapshot=(
                snapshot - 1 if is_on_demand else snapshot),
            total_snapshots=total_snapshots, comment=comment)
        if mesh_axes and pf.grid_io_mode == "inner":
            # gather-free: each shard writes its own hyperslab
            from ..io.snapshots import write_snapshot_sharded
            write_snapshot_sharded(filename, geom, params, state.y,
                                   u_shift=u_shift, **snap_kw)
        else:
            write_snapshot(
                filename, geom, params,
                _unshift(np.asarray(state.y), u_shift),
                grid_mode=pf.grid_io_mode, **snap_kw)
        log("OK]\n")
        log.commit()

        if is_on_demand:
            # trigger file is deleted after the snapshot (intertrack.c:330-334)
            try:
                os.remove(trigger_file)
            except OSError:
                pass
        else:
            snapshot += 1

    wall = time.time() - wall_start
    log("\nThe simulation has been completed successfully.\n"
        "Successful R-K steps: %d of %d total\n"
        "Solver wall time: %s\nOverall wall time: %s\n",
        int(state.steps), int(state.steps_total),
        format_time(elapsed_solver), format_time(wall))

    return {
        "steps": int(state.steps), "steps_total": int(state.steps_total),
        "wall": wall, "solver_wall": elapsed_solver, "t": float(state.t),
    }


def run_pproc(pf: ParamFile, log: RunLog, out_dir_arg: str,
              children: List[subprocess.Popen]) -> None:
    """Post-processing script execution (intertrack.c:2572-2640)."""
    script = pf.setting("pproc_script")
    if not script:
        return
    log("Executing the postprocessing script: %s %s\n", script, out_dir_arg)
    if pf.flag("pproc_nowait"):
        children.append(subprocess.Popen(
            [script, out_dir_arg],
            preexec_fn=lambda: os.nice(10)))
        if pf.flag("pproc_waitfirst") and len(children) == 1:
            code = children[0].wait()
            _check_pproc(pf, log, code)
    else:
        code = subprocess.call([script, out_dir_arg])
        _check_pproc(pf, log, code)


def _check_pproc(pf: ParamFile, log: RunLog, code: int) -> None:
    if code != 0:
        log("Warning: postprocessing script returned a nonzero exit status (%d).\n", code)
        if pf.flag("pproc_nofail"):
            raise IntertrackError("postprocessing failed (pproc_nofail set)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="intertrack",
        description="freezing/thawing phase-field simulator")
    ap.add_argument("param_file")
    ap.add_argument("positional", nargs="*",
                    help="[master_rank] [ubound_list] (reference CLI compat; "
                         "master_rank is ignored under SPMD)")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f64")
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec, e.g. 'z' or 'z2,y4' "
                         "(shard the grid over devices)")
    ap.add_argument("--platform", default=None,
                    help="run on this jax platform only (e.g. 'cpu' for "
                         "tests); default: the platform JAX selects")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace (xplane/tensorboard)"
                         " of the whole run into this directory — the "
                         "device-side analog of the reference's MPI_Wtime "
                         "phase instrumentation (SURVEY §5.1)")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()

    # reference CLI: intertrack param_file [master_rank] [ubound_list]
    ubound_list = ""
    extra = list(args.positional)
    if extra and extra[0].isdigit() and "," not in extra[0]:
        extra.pop(0)  # master_rank — meaningless under SPMD
    if extra:
        ubound_list = extra.pop(0)

    # x64 is always on: --precision selects the FIELD dtype only, while
    # the Merson controller scalars (t, h, eps comparisons) must be f64
    # regardless (solvers/merson.py::_scalar_dtype) — with f32 time
    # accumulation, t+h == t once h < ulp(t)/2 (~1 ms at t=36000 s) and
    # the solve stalls at the phase-switch discontinuity
    jax.config.update("jax_enable_x64", True)
    dtype = np.float64 if args.precision == "f64" else np.float32

    ubounds = [int(u) for u in ubound_list.split(",") if u] if ubound_list else []
    with open(args.param_file) as f:
        text = f.read()

    # peek at the logfile setting before full parsing so early errors land
    # in the log as well
    pre = parse_param_file(text, loop_vars={f"i{q+1}": 1 for q in range(20)}
                           | {"loopIter": 1})
    log = RunLog(pre.setting("logfile"))
    log("INTERTRACK phase interface evolution simulator\n")
    log("devices: %s\n", _device_summary())

    debug_log = None
    children: List[subprocess.Popen] = []
    total_iters = 1
    for u in ubounds:
        total_iters *= u
    if ubounds:
        log("\nENTERING BATCH PROCESSING MODE: %d loop%s defined, %d iterations in total.\n",
            len(ubounds), "s" if len(ubounds) > 1 else "", total_iters)

    profile_ctx = None
    if args.profile_dir:
        profile_ctx = jax.profiler.trace(args.profile_dir)
        profile_ctx.__enter__()
        log("Profiler trace -> %s\n", args.profile_dir)

    status = 0
    for loop_iter, loop_values in batch_iterations(ubounds):
        loop_env = {f"i{q+1}": (loop_values[q] if q < len(loop_values) else 1)
                    for q in range(20)}
        loop_env["loopIter"] = loop_iter
        if ubounds:
            log("\nSTARTING ITERATION %d OF %d:\n"
                "----------------------------------------------------------------------\n",
                loop_iter, total_iters)
            for q, v in enumerate(loop_values):
                log("i%d = %d\n", q + 1, v)
        pf = parse_param_file(text, loop_vars=loop_env)
        if pf.skipped:
            log("Iteration %d skipped. Continue...\n", loop_iter)
            continue

        if pf.setting("debug_logfile") and debug_log is None:
            debug_log = RKDebugLog(pf.setting("debug_logfile"),
                                   final_time=pf.get("final_time", 0.0))

        try:
            run_iteration(
                pf, log, loop_iter=loop_iter, loop_values=loop_values,
                loop_ubounds=ubounds or None, dtype=dtype,
                mesh_axes=args.mesh, debug_log=debug_log)
            out_dir_arg = (pf.setting("out_file")
                           + (loop_suffix(loop_values, ubounds, pf.mnemonics)
                              if ubounds else ""))
            run_pproc(pf, log, out_dir_arg, children)
        except (IntertrackError, ParamError) as exc:
            log("\nError: %s\nStop.\n", exc)
            status = 1
            break

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
    for child in children:
        child.wait()
    if debug_log is not None:
        debug_log.close()
    log.close()
    return status


def _device_summary() -> str:
    import jax
    return ", ".join(str(d) for d in jax.devices())


if __name__ == "__main__":
    sys.exit(main())
