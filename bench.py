"""Benchmark harness: freezing-stencil throughput on the attached device.

Default: the adaptive Runge-Kutta-Merson solve of the GradP phase-field +
heat system (calc_mode 0) on the reference's MR grid (100 x 100 x 200)
with the shipped Params physics and realistic initial conditions — warmed
into the stepping regime, then timed sustained.  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N/baseline,
     "ms_per_attempt": ..., "attempt_bytes": ..., "floor_ms": ...,
     "device": {...}}

``--form`` selects the attempt: ``delta`` (the increment form, the
intertrack app's f32 default) or ``classic`` (five ``make_rhs`` stages,
the f64 path).  ``attempt_bytes`` is the HBM traffic one attempt must
move (:func:`attempt_bytes`, computed from shapes) and ``floor_ms`` that
traffic at the device's published bandwidth.

``--matrix`` benches LR/MR/HR x GradP/SigmaP1-P/Temp plus the DEM contact
kernel, one row per child process (the parent never imports JAX, so one
process holds the card at a time), printing one JSON line per row; the
final line is the headline MR GradP row.

vs_baseline compares one card against the FULL reference configuration
of that case (1-7 CPU nodes; per-case sustained cell*RHS-evals/s derived
from the shipped logs, BASELINE.md).

A measurement names its device.  Without ``--platform cpu`` the run
fails unless JAX finds a GPU.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# reference sustained throughput per case, cells x attempted steps x 5
# stages / wall seconds from the shipped logs (BASELINE.md); config noted
BASELINES = {
    # (grid_nodes, calc_mode): evals/s
    (100, 0): 1.12e8,   # LR GradP, 32 cores (2:42:11, 870,988 att)
    (100, 1): 1.19e8,   # LR SigmaP1-P, 32 cores (1:10:38, 404,490 att)
    (100, 2): 3.11e8,   # LR Temp, 32 cores (0:23:48, 355,469 att)
    (200, 0): 2.40e8,   # MR GradP PhysRevE, 32 cores (23:57:27, 2,073,396)
    (200, 1): 2.45e8,   # MR SigmaP1-P PhysRevE, 32 cores (18:51:51)
    (200, 2): 2.00e8,   # MR Temp PhysRevE, 32 cores (20:33:06)
    (400, 1): 1.79e9,   # HR SigmaP1-P smallsigma, 384 cores (90:30:55)
    (400, 2): 1.22e9,   # HR Temp, 224 cores (104:47:12)
    (400, 0): None,     # no HR GradP reference run exists
}

MODE_NAMES = {0: "gradp", 1: "sigmap", 2: "temp"}
GRID_NAMES = {100: "lr", 200: "mr", 400: "hr"}

REPO = os.path.dirname(os.path.abspath(__file__))
REPO_BALLS = os.path.join(REPO, "data", "spheres_positions.txt")

# Published peak device-memory bandwidth by jax device_kind (NVIDIA H100
# SXM data sheet: 80 GB HBM3 at 3.35 TB/s).  A GPU missing here is an
# error, not a default.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

# Planes (one variable over the whole grid) each pass of one Merson
# attempt reads and writes when every pass reads its inputs once and
# writes its outputs once.  The classic and increment forms have the same
# structure: stage i reads the state (u, p, gl) plus the 2-variable K/G
# arrays its stage combination needs and writes one 2-variable K or G;
# the tail reads (u, p) and K1, K3/G3, K4/G4, K5/G5 for the error max and
# the speculative update; the commit selects between old and new (u, p).
ATTEMPT_PASSES = (
    ("stage1", 3, 2),
    ("stage2", 3 + 2, 2),
    ("stage3", 3 + 4, 2),
    ("stage4", 3 + 4, 2),
    ("stage5", 3 + 6, 2),
    ("error+update", 2 + 8, 2),
    ("commit", 4, 2),
)


def attempt_planes() -> int:
    """Single-variable planes one attempt moves through device memory."""
    return sum(r + w for _, r, w in ATTEMPT_PASSES)


def attempt_bytes(num_cells: int, itemsize: int) -> int:
    """Bytes one Merson attempt must move at the given grid and dtype —
    59 planes: 0.47 GB at MR f32, 3.8 GB at HR f32."""
    return attempt_planes() * num_cells * itemsize


def floor_ms(nbytes: int, device: dict):
    """The byte floor in ms at the device's published bandwidth; None on
    the CPU, which has no entry."""
    if device["platform"] == "cpu":
        return None
    try:
        return nbytes / PEAK_BYTES_PER_S[device["kind"]] * 1e3
    except KeyError:
        raise SystemExit(
            f"no peak bandwidth recorded for device kind {device['kind']!r}; "
            "add it to PEAK_BYTES_PER_S with its source")


def gpu_kernel_events(profile_dir):
    """(name, start_ns, duration_ns) of every event on the first GPU's
    lines of the newest jax.profiler trace under ``profile_dir``; [] when
    the trace has no GPU plane (a CPU run)."""
    import glob

    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        profile_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        return []
    planes = [p for p in ProfileData.from_file(paths[-1]).planes
              if p.name.startswith("/device:GPU:")]
    if not planes:
        return []
    planes.sort(key=lambda p: p.name)
    return [(e.name, e.start_ns, e.duration_ns)
            for line in planes[0].lines for e in line.events]


def kernel_breakdown(events, attempts, top=12):
    """Device metrics of a traced window of ``attempts`` Merson attempts:
    busy time (the union of event intervals), the window from the first
    event's start to the last one's end, the idle share 1 - busy/window,
    and the ``top`` kernels by total time, all per attempt in µs."""
    if not events or attempts <= 0:
        return None
    spans = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per_name = {}
    for name, _, d in events:
        n, t = per_name.get(name, (0, 0))
        per_name[name] = (n + 1, t + d)
    kernels = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "attempts": attempts,
        "busy_us_per_attempt": busy / attempts / 1e3,
        "window_us_per_attempt": window / attempts / 1e3,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "events_per_attempt": len(events) / attempts,
        "top_kernels_us_per_attempt": {
            name: round(t / attempts / 1e3, 2) for name, (n, t) in kernels},
    }


def log(*a):
    print(*a, file=sys.stderr, flush=True)


BASELINE_DEM_PARTICLE_EVALS_PER_S = 820.0
# MATLAB twin, 200-sphere dense porous-bed case: 200 particles x 151,969
# f-evals / 37,059 s (BASELINE.md spheres_200_dense.log)


def bench_dem(args, neighbor="dense", n_spheres=None, cell_capacity=16):
    import jax
    import jax.numpy as jnp
    from porousfreezethaw.models.dem import (
        DEMConfig, icond_dense, make_dem_rhs)
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    n = n_spheres or args.n_spheres
    # large-n beds use a proportionally smaller radius, like a finer bed
    r = 0.1 if n <= 400 else 0.1 * (200.0 / n) ** (1.0 / 3.0)
    cfg = DEMConfig(variant="friction_angular", n=n, r=r)
    y0, _ = icond_dense(cfg, seed=0)
    rhs = make_dem_rhs(cfg, dtype=jnp.float32, neighbor=neighbor,
                       cell_capacity=cell_capacity)
    steps = args.steps or (20000 if n <= 400 else 2000)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min, max_steps=steps,
                          handle_nan=True)
    solve = jax.jit(lambda st: merson_solve(rhs, st, 1e9, params))

    def run(st):
        st, _ = solve(st)
        if rhs.neighbor_struct is not None:
            # guarded capacity: mid-run densification past the
            # structure's capacity would drop pairs — the kernel already
            # NaN-poisons, this names the cause
            occ = rhs.neighbor_struct.cell_occupancy(st.y["pos"])
            if occ > rhs.neighbor_struct.capacity:
                raise RuntimeError(
                    f"cell occupancy {occ} exceeds capacity "
                    f"{rhs.neighbor_struct.capacity} at t="
                    f"{float(st.t):.4f} — rerun with a larger "
                    f"--cell-capacity or --neighbor dense")
        return st

    state = merson_init({k: jnp.asarray(v, jnp.float32) for k, v in y0.items()},
                        0.0, cfg.ht)
    log(f"compiling + warmup (n={n}, neighbor={neighbor})...")
    state = run(state)
    n0 = int(state.steps_total)
    log(f"timing {steps} attempted steps (t={float(state.t):.3f}s sim)...")
    with profiled(args.profile_dir):
        t0 = time.perf_counter()
        state = run(state)
        done = int(state.steps_total) - n0
        wall = time.perf_counter() - t0
    value = 5.0 * cfg.n * done / wall
    log(f"{done} attempts, {wall:.2f}s -> {value:.3e} particle*RHS-evals/s "
        f"(t={float(state.t):.3f}s sim)")
    suffix = {"dense": "", "cell_list": "_celllist",
              "cell_roll": "_cellroll",
              "cell_lanes": "_celllanes"}[neighbor]
    return {
        "metric": f"dem_{n}{suffix}_particle_rhs_evals_per_s",
        "value": value,
        "unit": "particle*RHS-evals/s/device",
        "vs_baseline": (value / BASELINE_DEM_PARTICLE_EVALS_PER_S
                        if n == 200 else None),
        "ms_per_attempt": wall / done * 1e3,
        "attempts_timed": done,
    }


def bench_copy(args):
    """Achieved device-memory bandwidth of a plain XLA elementwise pass
    (y = x + 1 over a 1 GiB f32 array: one read, one write) — what a
    bandwidth-bound kernel can reach on this card, for roofline shares."""
    import jax
    import jax.numpy as jnp
    n = (1 << 30) // 4
    x = jnp.zeros((n,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(f(x))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        x = f(x)
    jax.block_until_ready(x)
    wall = time.perf_counter() - t0
    value = 2 * 4 * n * reps / wall
    log(f"copy: {value / 1e12:.3f} TB/s")
    return {"metric": "device_copy_bytes_per_s", "value": value,
            "unit": "bytes/s", "vs_baseline": None}


def bench_freezing(args, grid_nodes=None, calc_mode=0):
    import jax
    import jax.numpy as jnp

    from porousfreezethaw.cases import freezing_params_text
    from porousfreezethaw.config import parse_param_file
    from porousfreezethaw.core.grid import GridGeometry
    from porousfreezethaw.models.freezing import (
        FreezingParams, build_glass_field, build_initial_conditions,
        make_rhs, shift_temperature_origin)
    from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
    from porousfreezethaw.models.freezing.glass import read_ball_positions
    from porousfreezethaw.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    grid_nodes = grid_nodes or args.grid_nodes
    dtype = np.float64 if args.dtype == "f64" else np.float32

    pf = parse_param_file(
        freezing_params_text(grid_nodes=grid_nodes, calc_mode=calc_mode),
        env={"OUTPUT": "."})
    prm = FreezingParams.from_dict(pf.vars)
    geom = GridGeometry(pf.vars["L1"], pf.vars["L2"], pf.vars["L3"],
                        int(pf.vars["n1"]), int(pf.vars["n2"]),
                        int(pf.vars["n3"]))
    log(f"grid: {geom.n1} x {geom.n2} x {geom.n3} "
        f"({geom.num_cells/1e6:.2f} M cells), calc_mode {calc_mode}, "
        f"dtype {args.dtype}, form {args.form}")

    icond = dict(pf.icond_formulas)
    if calc_mode == 2:
        icond["p"] = "0"  # Model 2 requires p=0 (reference Params comment)
    w0 = build_initial_conditions(geom, prm, icond, dtype=dtype)
    balls = read_ball_positions(args.ball_positions or REPO_BALLS, prm)
    w0[2] = build_glass_field(geom, prm, balls, w0[2])

    # f32 conditioning: store u - u_star (exact; see
    # models/freezing/parameters.py::shift_temperature_origin)
    if dtype == np.float32:
        w0[0] -= prm.u_star
        prm_solver = shift_temperature_origin(prm, prm.u_star)
    else:
        prm_solver = prm

    rhs = make_rhs(geom, prm_solver, calc_mode=calc_mode)
    attempt_fn = (XlaDeltaAttempt(geom, prm_solver, calc_mode)
                  if args.form == "delta" else None)

    steps = args.steps
    if steps == 0:
        steps = max(20, int(4e8 / geom.num_cells))
    warm = args.warm_steps
    if warm == 0:
        warm = min(4 * steps, max(steps, int(2e9 / geom.num_cells)))

    # NaN backoff on (the reference's recommended setting for rough starts,
    # RK_Asolver.c:96-131) and a tame initial tau: in f32 the tau=1
    # transient overflows the stage cascade.  accept_growth_min is the
    # classic f32 noise-floor escape (see MersonParams), as in the app;
    # the increment form keeps the exact reference rule.
    params = MersonParams(
        delta=pf.vars["delta"], h_min=pf.vars["tau_min"], max_steps=steps,
        handle_nan=True,
        accept_growth_min=(1.05 if dtype == np.float32
                           and attempt_fn is None else 0.0))
    # ONE compiled program for both warmup and timing: max_steps is baked
    # into the while_loop, so warm/timed programs with different counts
    # would each pay their own compilation inside the timed section
    solve = jax.jit(lambda st: merson_solve(
        rhs, st, 1e9, params, attempt_fn=attempt_fn))

    w_dev = jnp.asarray(w0, dtype)
    if args.mesh:
        from porousfreezethaw.parallel.sharding import (
            make_mesh, shard_freezing_state)
        mesh = make_mesh(args.mesh)
        w_dev = shard_freezing_state(w_dev, mesh)
        log(f"state sharded over "
            f"{dict(zip(mesh.axis_names, mesh.devices.shape))}")
    state = merson_init(w_dev, 0.0, min(pf.vars["tau"], 1e-4))
    log(f"compiling + warming >= {warm} attempted steps into the stepping "
        f"regime ({steps} per solver call)...")
    t0 = time.perf_counter()
    for _ in range(max(1, -(-warm // steps))):
        state, _ = solve(state)
    jax.block_until_ready(state)
    log(f"warmup done in {time.perf_counter()-t0:.1f}s "
        f"({int(state.steps)}/{int(state.steps_total)} steps, "
        f"t={float(state.t):.4f}s sim, h={float(state.h):.3e})")

    log(f"timing {steps} attempted steps (sustained)...")
    before = int(state.steps_total)
    with profiled(args.profile_dir):
        t0 = time.perf_counter()
        state, _ = solve(state)
        jax.block_until_ready(state)
        wall = time.perf_counter() - t0
    done = int(state.steps_total) - before

    value = 5.0 * geom.num_cells * done / wall
    log(f"{done} attempted steps ({int(state.steps)} successful so far), "
        f"t={float(state.t):.4f}s sim, {wall:.2f}s wall -> "
        f"{value:.3e} cell*RHS-evals/s")

    base = BASELINES.get((grid_nodes, calc_mode))
    metric = (f"freezing_{MODE_NAMES[calc_mode]}_"
              f"{GRID_NAMES.get(grid_nodes, grid_nodes)}_{args.form}_"
              f"{args.dtype}_cell_rhs_evals_per_s")
    return {
        "metric": metric,
        "value": value,
        "unit": "cell*RHS-evals/s/device",
        "vs_baseline": (value / base) if base else None,
        "ms_per_attempt": wall / done * 1e3,
        "attempt_bytes": attempt_bytes(geom.num_cells,
                                       np.dtype(dtype).itemsize),
        "attempts_timed": done,
    }


def profiled(profile_dir):
    """A jax.profiler trace of the timed window when asked for (the
    trace slows the host, so timings from a traced run are not kept)."""
    import jax
    return (jax.profiler.trace(profile_dir) if profile_dir
            else contextlib.nullcontext())


def require_device(platform):
    """The device record of this run; a run that asked for no platform
    must find a GPU."""
    import jax

    from porousfreezethaw.core.runtime import device_record
    if platform:
        jax.config.update("jax_platforms", platform)
    try:
        dev = device_record()
    except RuntimeError as exc:
        raise SystemExit(f"no accelerator found: {exc}")
    if platform is None and dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU found (JAX runs on {dev['platform']}); pass "
            "--platform cpu to bench the CPU")
    return dev


def run_matrix(args):
    """Each row in its own child process; this process never imports
    JAX, so only one process holds the card at a time."""
    specs = [f"freezing:{gn}:{cm}" for gn in (100, 200, 400)
             for cm in (0, 1, 2)]
    specs += [f"dem:{n}:{nb}" for n, nb in (
        (200, "dense"), (2000, "dense"), (4000, "dense"),
        (4000, "cell_lanes"), (10000, "cell_lanes"))]
    results = []
    for spec in specs:
        cmd = [sys.executable, os.path.abspath(__file__), "--row", spec,
               "--dtype", args.dtype, "--form", args.form]
        for flag, val in (("--platform", args.platform),
                          ("--steps", args.steps),
                          ("--warm-steps", args.warm_steps)):
            if val:
                cmd += [flag, str(val)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.stderr:
            log(out.stderr.rstrip()[-2000:])
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            rec = {"metric": spec, "value": None,
                   "error": f"rc={out.returncode}"}
        else:
            rec = json.loads(lines[-1])
        results.append(rec)
        print(json.dumps(rec), flush=True)
    head = results[3]  # MR GradP
    print(json.dumps(head))
    return 0 if all(r.get("value") is not None for r in results) else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=["freezing", "dem", "copy"],
                    default="freezing",
                    help="copy: achieved bandwidth of a plain 1 GiB "
                         "elementwise pass (the roofline reference)")
    ap.add_argument("--matrix", action="store_true",
                    help="bench LR/MR/HR x GradP/SigmaP/Temp + DEM; one "
                         "JSON line each (each row in its own process)")
    ap.add_argument("--row", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--n-spheres", type=int, default=200)
    ap.add_argument("--neighbor", choices=["dense", "cell_list",
                                           "cell_roll", "cell_lanes"],
                    default="dense",
                    help="DEM neighbor strategy (--suite dem)")
    ap.add_argument("--grid-nodes", type=int, default=200,
                    help="cells along the longest side: 100=LR, 200=MR, 400=HR")
    ap.add_argument("--calc-mode", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--form", choices=["delta", "classic"], default="delta",
                    help="Merson attempt: increment form (the app's f32 "
                         "default) or classic make_rhs stages")
    ap.add_argument("--steps", type=int, default=0,
                    help="attempted Merson steps to time (0 = auto)")
    ap.add_argument("--warm-steps", type=int, default=0,
                    help="attempted steps before timing (0 = auto)")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--platform", default=None,
                    help="run on this jax platform (cpu for tests); "
                         "default: fail unless JAX finds a GPU")
    ap.add_argument("--mesh", default=None,
                    help="shard the state over a device mesh spec "
                         "(e.g. 'z4' or 'z2,y2')")
    ap.add_argument("--ball-positions", default=None)
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of the timed window "
                         "into this directory and add its per-kernel "
                         "breakdown to the record")
    args = ap.parse_args()

    if args.grid_nodes < 4:
        ap.error("--grid-nodes must be >= 4")
    if args.matrix:
        return run_matrix(args)

    import jax

    from porousfreezethaw.core.runtime import enable_compile_cache
    enable_compile_cache()
    device = require_device(args.platform)
    # x64 always on: field dtype is selected separately; the Merson
    # controller scalars must be f64 (see apps/intertrack.py)
    jax.config.update("jax_enable_x64", True)
    log(f"device: {device}")

    if args.row:
        parts = args.row.split(":")
        if parts[0] == "freezing":
            rec = bench_freezing(args, grid_nodes=int(parts[1]),
                                 calc_mode=int(parts[2]))
        else:
            rec = bench_dem(args, n_spheres=int(parts[1]), neighbor=parts[2],
                            cell_capacity=8 if parts[2] != "dense" else 16)
    elif args.suite == "dem":
        rec = bench_dem(args, neighbor=args.neighbor)
    elif args.suite == "copy":
        rec = bench_copy(args)
    else:
        rec = bench_freezing(args, calc_mode=args.calc_mode)
    if "attempt_bytes" in rec:
        rec["floor_ms"] = floor_ms(rec["attempt_bytes"], device)
    if args.profile_dir and "attempts_timed" in rec:
        rec["trace"] = kernel_breakdown(gpu_kernel_events(args.profile_dir),
                                        rec["attempts_timed"])
    rec["device"] = device
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
