"""Smoke test of the main path on one NVIDIA GPU (or four with --four).

    python chip_smoke.py            # phases (a)-(d) on one card
    python chip_smoke.py --four     # the 4-card MR runs against one card
    python chip_smoke.py --rehearse [--four]   # tiny sizes on the CPU

Phases, all in this one process (a JAX process reserves most of the
card's memory, so a second one could not start):

(a) MR production run: ``apps.intertrack.main`` on the PhysRevE MR GradP
    case (100 x 100 x 200, 2 M cells) in f32 increment form for two
    snapshot intervals of the shipped spacing, then the first interval
    again in f64 (the app's default).
(b) Checks against the plain reference on the card: the LR golden step
    counts (GradP f32 delta and Temp f64) against the reference log; the
    increment form G = f(w+d) - f(w) at MR in f32 against the f64 direct
    difference; one f32 delta attempt at MR against the classic f64
    attempt.
(c) HR (200 x 200 x 400, 16 M cells) f32 delta: compile and run one chunk
    of attempts.
(d) DEM settle: ``apps.spheres.main``, friction_angular, n=200.

Every phase prints one JSON line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
and is printed only when every phase passed on a GPU; otherwise the
script exits non-zero without it.

Tolerances (each with its reason):

* golden counts: within 5% of the reference log (3560/4322 GradP,
  1850/2256 Temp), the band the CPU suite holds (tests/test_golden_lr.py);
  FP summation order moves snapshot-1 counts by a few per mille.
* increment form: max |G_f32 - D_f64| / max |D_f64| <= 1e-3 per variable.
  G is computed in f32 with relative rounding (its terms all carry a
  factor of the small increment), amplified by the conditioning of the
  rational and tanh expansions; FMA contraction and the GPU's exp/sqrt
  differ from the CPU's in the last bits.
* one attempt: speculative (u, p) within 1e-5 of max |y| per variable
  (f32 state quantization, ulp 4e-6 at |u - u*| = 45 K), error estimate
  within 5e-2 relative: it is a difference of three G's, each
  f32-rounded, and enters the controller as eps^0.2, so 5% in eps moves
  the next step by 1%.
* --four: equal step counts and fields within 1e-3 of max |y| per
  variable: the sharded program fuses differently, so rounding differs
  in the last bits and accumulates over an interval.
"""

import argparse
import json
import os
import re
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, ".chip_smoke")

REF_GRADP = (3560, 4322)     # reference Cases-LR GradP log, snapshot 1
REF_TEMP = (1850, 2256)      # reference Cases-LR Temp log, snapshot 1
CPU_GRADP = (3647, 4323)     # this code on the CPU (tests/test_golden_lr.py)

G_TOL = 1e-3
ATTEMPT_Y_TOL = 1e-5
ATTEMPT_EPS_TOL = 5e-2
FOUR_FIELD_TOL = 1e-3
GOLDEN_BAND = 0.05


def emit(rec):
    print(json.dumps(rec), flush=True)


class PhaseFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def run_app(params_text, workdir, argv=()):
    """One ``apps.intertrack.main`` run in ``workdir``; returns its log."""
    from porousfreezethaw.apps.intertrack import main
    os.makedirs(workdir, exist_ok=True)
    pfile = os.path.join(workdir, "Params")
    with open(pfile, "w") as f:
        f.write(params_text)
    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = workdir
    try:
        rc = main([pfile, *argv])
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
    with open(os.path.join(workdir, "intertrack.log")) as f:
        log = f.read()
    require(rc == 0, f"intertrack exited {rc}: {log[-1500:]}")
    return log


def _seconds(hms):
    h, m, s = hms.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


def intervals(log):
    """Per-interval (solver wall s, successful, attempted), from the
    app's cumulative 'Done ...' lines (snapshot 0 is the start)."""
    rows = [(_seconds(w), int(a), int(b)) for w, a, b in re.findall(
        r"elapsed wall time: (\S+), (\d+) R-K steps \((\d+) total\)", log)]
    out = []
    for prev, cur in zip(rows, rows[1:]):
        out.append({"solver_wall_s": round(cur[0] - prev[0], 2),
                    "steps": cur[1] - prev[1],
                    "attempts": cur[2] - prev[2]})
    return out


def final_counts(log):
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    require(m is not None, "no final step counts in the log")
    return int(m[1]), int(m[2])


def check_snapshots(workdir, names):
    from porousfreezethaw.io.netcdf3 import read_netcdf
    import numpy as np
    fields = {}
    for name in names:
        path = os.path.join(workdir, name)
        require(os.path.exists(path), f"missing snapshot {name}")
        data = read_netcdf(path)
        for v in ("u", "p", "gl"):
            require(np.isfinite(data.variables[v]).all(),
                    f"non-finite {v} in {name}")
        fields[name] = data
    return fields


def memory_stats():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_analysis(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(ma, k)}


def load_case(grid_nodes, calc_mode):
    """(geom, params, parsed Params) of the benchmark case."""
    from porousfreezethaw.cases import freezing_params_text
    from porousfreezethaw.config import parse_param_file
    from porousfreezethaw.core.grid import GridGeometry
    from porousfreezethaw.models.freezing import FreezingParams
    pf = parse_param_file(freezing_params_text(grid_nodes=grid_nodes,
                                               calc_mode=calc_mode),
                          env={"OUTPUT": OUT})
    geom = GridGeometry(pf.vars["L1"], pf.vars["L2"], pf.vars["L3"],
                        int(pf.vars["n1"]), int(pf.vars["n2"]),
                        int(pf.vars["n3"]))
    return geom, FreezingParams.from_dict(pf.vars), pf


def initial_state_f32(grid_nodes, calc_mode):
    """(geom, shifted params, initial state) of the benchmark case in the
    app's f32 layout (u stored as u - u_star)."""
    import numpy as np
    from porousfreezethaw.models.freezing import (
        build_glass_field, build_initial_conditions, read_ball_positions,
        shift_temperature_origin)
    geom, prm, pf = load_case(grid_nodes, calc_mode)
    w0 = build_initial_conditions(geom, prm, pf.icond_formulas,
                                  dtype=np.float32)
    balls = read_ball_positions(
        os.path.join(HERE, "data", "spheres_positions.txt"), prm)
    w0[2] = build_glass_field(geom, prm, balls, w0[2])
    w0[0] -= prm.u_star
    return geom, shift_temperature_origin(prm, prm.u_star), w0


def compile_delta_solve(geom, prm, calc_mode, w32, max_steps):
    """The app's f32 solve program: XlaDeltaAttempt under the exact
    reference step-control rule with the NaN backoff."""
    import jax
    import jax.numpy as jnp
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)
    att = XlaDeltaAttempt(geom, prm, calc_mode)
    params = MersonParams(delta=1e-3, h_min=1e-6, handle_nan=True,
                          max_steps=max_steps)
    state = merson_init(jnp.asarray(w32), 0.0, 1e-4)
    t0 = time.perf_counter()
    compiled = jax.jit(lambda st, ft: merson_solve(
        None, st, ft, params, attempt_fn=att)).lower(state, 1e9).compile()
    return compiled, state, time.perf_counter() - t0


# ---------------------------------------------------------------- phases

def phase_mr(sizes):
    from porousfreezethaw.cases import freezing_params_text
    gn = sizes["mr"]
    text = freezing_params_text(grid_nodes=gn, calc_mode=0,
                                final_time_hours=2 * 10 / 99, saved_files=3)
    d32 = os.path.join(OUT, "mr_f32")
    log = run_app(text, d32, ("--precision", "f32"))
    require("Increment-form (delta) attempt: ON" in log,
            "the f32 run did not take the increment form")
    check_snapshots(d32, ["image.000.ncd", "image.001.ncd", "image.002.ncd"])
    iv32 = intervals(log)
    steps, total = final_counts(log)

    text64 = freezing_params_text(grid_nodes=gn, calc_mode=0,
                                  final_time_hours=10 / 99, saved_files=2)
    d64 = os.path.join(OUT, "mr_f64")
    log64 = run_app(text64, d64)
    require("Increment-form" not in log64, "f64 took the increment form")
    check_snapshots(d64, ["image.000.ncd", "image.001.ncd"])
    iv64 = intervals(log64)

    geom, prm, w32 = initial_state_f32(gn, 0)
    compiled, _, compile_s = compile_delta_solve(geom, prm, 0, w32, 2**62)
    second = iv32[-1]
    return {
        "grid": [geom.n1, geom.n2, geom.n3],
        "f32_delta_intervals": iv32, "f32_steps": steps,
        "f32_attempts": total,
        "f32_ms_per_attempt_interval2": round(
            1e3 * second["solver_wall_s"] / max(second["attempts"], 1), 4),
        "f64_intervals": iv64,
        # includes the f64 program's compilation
        "f64_ms_per_attempt_interval1": round(
            1e3 * iv64[0]["solver_wall_s"] / max(iv64[0]["attempts"], 1), 4),
        "solve_compile_s": round(compile_s, 2),
        "solve_memory_analysis": memory_analysis(compiled),
        "peak_bytes_in_use": memory_stats(),
    }


def phase_golden(sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from porousfreezethaw.config import parse_param_file
    from porousfreezethaw.core.grid import GridGeometry
    from porousfreezethaw.models.freezing import (
        FreezingParams, build_glass_field, build_initial_conditions,
        read_ball_positions, shift_temperature_origin)
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    def shrink(text):
        # one reference snapshot interval: with saved_files=100 the
        # snapshots fall final_time/99 apart (intertrack.c:2265-2271)
        final = sizes["golden_time"] or "10*hours/99"
        text = re.sub(r"^final_time\s+\S+", f"final_time {final}", text,
                      flags=re.M)
        text = re.sub(r"^saved_files\s+\S+", "saved_files 2", text,
                      flags=re.M)
        return re.sub(r"^grid_nodes\s+\S+",
                      f"grid_nodes {sizes['golden']}", text, flags=re.M)

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "Params-LR-GradP")) as f:
        pf = parse_param_file(shrink(f.read()), env={"OUTPUT": OUT})
    prm = FreezingParams.from_dict(pf.vars)
    geom = GridGeometry(pf.vars["L1"], pf.vars["L2"], pf.vars["L3"],
                        int(pf.vars["n1"]), int(pf.vars["n2"]),
                        int(pf.vars["n3"]))
    w0 = build_initial_conditions(geom, prm, pf.icond_formulas,
                                  dtype=np.float32)
    balls = read_ball_positions(
        os.path.join(HERE, "data", "spheres_positions.txt"), prm)
    w0[2] = build_glass_field(geom, prm, balls, w0[2])
    w0[0] -= prm.u_star
    att = XlaDeltaAttempt(geom, shift_temperature_origin(prm, prm.u_star), 0)
    params = MersonParams(delta=pf.vars["delta"], h_min=pf.vars["tau_min"],
                          handle_nan=True)
    t0 = time.perf_counter()
    st, status = jax.jit(lambda s: merson_solve(
        None, s, pf.vars["final_time"], params, attempt_fn=att))(
            merson_init(jnp.asarray(w0), 0.0, pf.vars["tau"]))
    gradp = (int(st.steps), int(st.steps_total))
    gradp_wall = time.perf_counter() - t0
    require(int(status) == 0, f"GradP golden solve status {int(status)}")

    with open(os.path.join(golden, "Params-LR-Temp")) as f:
        text = shrink(f.read())
    dtemp = os.path.join(OUT, "golden_temp")
    t0 = time.perf_counter()
    temp = final_counts(run_app(text, dtemp))
    temp_wall = time.perf_counter() - t0

    rec = {"gradp_f32_delta": gradp, "gradp_reference": REF_GRADP,
           "gradp_cpu": CPU_GRADP, "gradp_wall_s": round(gradp_wall, 2),
           "temp_f64_app": temp, "temp_reference": REF_TEMP,
           "temp_wall_s": round(temp_wall, 2)}
    if sizes["golden"] == 100:
        for got, ref, name in ((gradp, REF_GRADP, "GradP"),
                               (temp, REF_TEMP, "Temp")):
            for g, r in zip(got, ref):
                require(abs(g - r) <= GOLDEN_BAND * r,
                        f"{name} counts {got} outside 5% of {ref}")
    return rec


def _mr_state(sizes):
    """The developed MR state after one f32 interval of phase (a), in
    the app's f32 layout, with its grid, shifted parameters, time and
    continuation step."""
    import numpy as np
    from porousfreezethaw.io.snapshots import load_checkpoint
    from porousfreezethaw.models.freezing import shift_temperature_origin
    geom, prm, _ = load_case(sizes["mr"], 0)
    ck = load_checkpoint(os.path.join(OUT, "mr_f32", "image.001.ncd"))
    w32 = ck.fields.astype(np.float32)
    w32[0] = (ck.fields[0] - prm.u_star).astype(np.float32)
    return geom, shift_temperature_origin(prm, prm.u_star), w32, ck.t, ck.tau


def phase_increment_form(sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from porousfreezethaw.models.freezing import make_rhs
    from porousfreezethaw.models.freezing.delta import make_g_rhs
    geom, prm, w32, t, h = _mr_state(sizes)
    w64 = jnp.asarray(w32, jnp.float64)
    out = {}
    for mode in (0, 1, 2):
        rhs = jax.jit(make_rhs(geom, prm, mode))
        g = jax.jit(make_g_rhs(geom, prm, mode))
        K1 = rhs(t, w64)[:2]
        d32 = (h * K1).astype(jnp.float32)
        d64 = d32.astype(jnp.float64)
        direct = np.asarray((rhs(t + h, w64.at[:2].add(d64))
                             - rhs(t, w64))[:2])
        G = np.asarray(g(t, t + h, jnp.asarray(w32), d32), np.float64)
        err = [float(np.abs(G[q] - direct[q]).max()
                     / max(np.abs(direct[q]).max(), 1e-300))
               for q in range(2)]
        out[f"mode{mode}_rel_err_u_p"] = err
        require(max(err) <= G_TOL,
                f"mode {mode}: G f32 vs f64 difference {err} > {G_TOL}")
    out["h"] = h
    out["tol"] = G_TOL
    return out


def phase_attempt(sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from porousfreezethaw.models.freezing import make_rhs
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    geom, prm, w32, t, h = _mr_state(sizes)
    w64 = jnp.asarray(w32, jnp.float64)

    rhs = make_rhs(geom, prm, 0)

    @jax.jit
    def classic(w):
        K1 = rhs(t, w)
        K2 = rhs(t + h / 3, w + (h / 3) * K1)
        K3 = rhs(t + h / 3, w + (h / 6) * (K1 + K2))
        K4 = rhs(t + h / 2, w + (h / 8) * (K1 + 3 * K3))
        K5 = rhs(t + h, w + h * (0.5 * K1 - 1.5 * K3 + 2 * K4))
        eps = jnp.max(jnp.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5))
        return (w + (h / 3) * (0.5 * (K1 + K5) + 2 * K4))[:2], eps

    want_y, want_eps = classic(w64)
    att = XlaDeltaAttempt(geom, prm, 0)
    (_, spec), eps = jax.jit(lambda y: att.attempt(
        jnp.asarray(t, jnp.float64), jnp.asarray(h, jnp.float64), y))(
            jnp.asarray(w32))
    want_y = np.asarray(want_y)
    scale = np.abs(want_y).max(axis=(1, 2, 3))
    yerr = [float(np.abs(np.asarray(spec, np.float64)[q] - want_y[q]).max()
                  / scale[q]) for q in range(2)]
    got_eps, want_eps = float(jnp.max(eps)), float(want_eps)
    eps_err = abs(got_eps - want_eps) / want_eps
    require(max(yerr) <= ATTEMPT_Y_TOL, f"attempt y difference {yerr}")
    require(eps_err <= ATTEMPT_EPS_TOL,
            f"attempt eps {got_eps} vs f64 classic {want_eps}")
    return {"h": h, "y_rel_err_u_p": yerr, "eps_f32_delta": got_eps,
            "eps_f64_classic": want_eps, "eps_rel_err": eps_err}


def phase_hr(sizes):
    import jax
    import numpy as np
    geom, prm, w32 = initial_state_f32(sizes["hr"], 0)
    n = sizes["hr_attempts"]
    compiled, state, compile_s = compile_delta_solve(geom, prm, 0, w32, n)
    st, _ = compiled(state, 1e9)          # warm: first execution
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    st2, _ = compiled(st, 1e9)
    jax.block_until_ready(st2)
    wall = time.perf_counter() - t0
    attempts = int(st2.steps_total) - int(st.steps_total)
    y = np.asarray(st2.y)
    require(np.isfinite(y).all(), "non-finite HR state")
    require(attempts == n, f"HR chunk ran {attempts} of {n} attempts")
    return {"grid": [geom.n1, geom.n2, geom.n3], "attempts": attempts,
            "steps": int(st2.steps) - int(st.steps),
            "ms_per_attempt": round(1e3 * wall / attempts, 4),
            "compile_s": round(compile_s, 2),
            "memory_analysis": memory_analysis(compiled),
            "peak_bytes_in_use": memory_stats()}


def phase_dem(sizes):
    import numpy as np
    from porousfreezethaw.apps.spheres import main as spheres_main
    from porousfreezethaw.io.csv_snaps import read_dem_snapshot, snapshot_path
    out = os.path.join(OUT, "dem")
    n, snaps = sizes["dem_n"], 5
    t0 = time.perf_counter()
    rc = spheres_main(["--variant", "friction_angular", "--n", str(n),
                       "--snapshots", str(snaps), "--final-time",
                       str(sizes["dem_time"]), "--seed", "0",
                       "--output", out])
    wall = time.perf_counter() - t0
    require(rc == 0, f"spheres exited {rc}")
    for s in range(1, snaps + 1):
        path = snapshot_path(out, s)
        require(os.path.exists(path), f"missing {path}")
        cols = read_dem_snapshot(path)
        for k, v in cols.items():
            require(np.isfinite(np.asarray(v, float)).all(),
                    f"non-finite {k} in snapshot {s}")
        require(len(cols["x"]) == n, f"snapshot {s} has {len(cols['x'])} rows")
    return {"n": n, "snapshots": snaps, "final_time": sizes["dem_time"],
            "wall_s": round(wall, 2)}


def phase_four(sizes):
    """MR GradP f32 delta through the app on one card, on z4 and on
    z2,y2: equal step counts, fields within FOUR_FIELD_TOL."""
    import numpy as np
    from porousfreezethaw.cases import freezing_params_text
    text = freezing_params_text(grid_nodes=sizes["mr"], calc_mode=0,
                                final_time_hours=sizes["four_hours"],
                                saved_files=2)
    runs = {}
    for label, argv in (("single", ()), ("z4", ("--mesh", "z4")),
                        ("z2,y2", ("--mesh", "z2,y2"))):
        d = os.path.join(OUT, "four_" + label.replace(",", "_"))
        log = run_app(text, d, ("--precision", "f32", *argv))
        require("Increment-form (delta) attempt: ON" in log,
                f"{label}: not the increment form")
        snap = check_snapshots(d, ["image.001.ncd"])["image.001.ncd"]
        runs[label] = (final_counts(log), intervals(log)[0]["solver_wall_s"],
                       {v: np.asarray(snap.variables[v]) for v in
                        ("u", "p", "gl")})
    base_counts, base_wall, base = runs["single"]
    rec = {"single": {"counts": base_counts, "solver_wall_s": base_wall}}
    for label in ("z4", "z2,y2"):
        counts, wall, f = runs[label]
        err = {v: float(np.abs(f[v] - base[v]).max()
                        / max(np.abs(base[v]).max(), 1e-300))
               for v in base}
        rec[label] = {"counts": counts, "solver_wall_s": wall,
                      "field_rel_err": err}
    emit({"phase": "four_detail", **rec})
    for label in ("z4", "z2,y2"):
        require(rec[label]["counts"] == base_counts,
                f"{label}: counts {rec[label]['counts']} != single "
                f"{base_counts}")
        require(max(rec[label]["field_rel_err"].values()) <= FOUR_FIELD_TOL,
                f"{label}: fields differ by {rec[label]['field_rel_err']}")
    return rec


FULL = {"mr": 200, "hr": 400, "hr_attempts": 100, "golden": 100,
        "golden_time": None, "dem_n": 200, "dem_time": 0.5,
        "four_hours": 10 / 99}
TINY = {"mr": 12, "hr": 16, "hr_attempts": 5, "golden": 12,
        "golden_time": 5, "dem_n": 12, "dem_time": 0.1,
        "four_hours": 5 / 3600}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card MR mesh comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU (4 virtual devices); "
                         "prints no result line")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")
        os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        import jax
        from porousfreezethaw.core.runtime import (
            enable_compile_cache, gpu_name_and_power_limit)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the program ({exc}); run it from "
              "the repository root", file=sys.stderr)
        return 2
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU found (JAX runs on {platform})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} devices, found {len(devs)}",
              file=sys.stderr)
        return 2
    card = gpu_name_and_power_limit()
    emit({"phase": "device", "platform": platform,
          "kind": devs[0].device_kind, "count": len(devs), "card": card})

    sizes = TINY if args.rehearse else FULL
    phases = ([("four", phase_four)] if args.four else [
        ("a_mr_production", phase_mr),
        ("b_golden_counts", phase_golden),
        ("b_increment_form_mr", phase_increment_form),
        ("b_one_attempt_mr", phase_attempt),
        ("c_hr_size", phase_hr),
        ("d_dem_settle", phase_dem)])
    shutil.rmtree(OUT, ignore_errors=True)
    failed = []
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                rec = fn(sizes)
                ok = True
            except Exception as exc:  # noqa: BLE001 — report, run the rest
                rec = {"error": f"{type(exc).__name__}: {exc}"[:2000]}
                ok = False
                failed.append(name)
            emit({"phase": name, "ok": ok,
                  "wall_s": round(time.perf_counter() - t0, 2), **rec})
    finally:
        shutil.rmtree(OUT, ignore_errors=True)

    print(f"card: {card}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (no result line on the CPU)",
              file=sys.stderr)
        return 0
    emit({"ok": True, "device": {"platform": platform,
                                 "kind": devs[0].device_kind,
                                 "count": len(devs) if args.four else 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
