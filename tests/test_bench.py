"""bench.py harness tests (CPU, tiny grid).

A recorded benchmark once lost 14x to a harness bug (the timed section
silently included a second program's compilation), so the harness itself
is under test: the JSON contract, the one-compiled-program structure,
the device record, the byte floor and the DEM suite.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_bench(*args, timeout=600, platform=("--platform", "cpu")):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), *platform, *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def run_bench_ok(*args, timeout=600):
    out = run_bench(*args, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    return json.loads(line), out.stderr


@pytest.mark.slow
def test_freezing_json_contract():
    rec, err = run_bench_ok("--grid-nodes", "8", "--steps", "5",
                            "--warm-steps", "5", "--dtype", "f64",
                            "--form", "classic")
    assert rec["unit"] == "cell*RHS-evals/s/device"
    assert rec["value"] > 0
    assert rec["ms_per_attempt"] > 0
    # 8 != a named grid: metric generalizes
    assert rec["metric"] == "freezing_gradp_8_classic_f64_cell_rhs_evals_per_s"
    assert rec["device"]["platform"] == "cpu"
    assert rec["floor_ms"] is None       # no device bandwidth on the CPU
    # warmup and timing share ONE compiled program: the log announces a
    # per-call step count equal to the timed steps
    assert "(5 per solver call)" in err


@pytest.mark.slow
def test_dem_json_contract():
    rec, _ = run_bench_ok("--suite", "dem", "--n-spheres", "8",
                          "--steps", "50")
    assert rec["metric"] == "dem_8_particle_rhs_evals_per_s"
    assert rec["unit"] == "particle*RHS-evals/s/device"
    assert rec["value"] > 0
    assert rec["vs_baseline"] is None  # baseline defined only for n=200


@pytest.mark.parametrize("form", ["delta", "classic"])
def test_freezing_form_and_device_record(form):
    rec, err = run_bench_ok("--grid-nodes", "6", "--steps", "3",
                            "--warm-steps", "3", "--form", form)
    assert rec["metric"] == f"freezing_gradp_6_{form}_f32_cell_rhs_evals_per_s"
    assert rec["value"] > 0
    assert set(rec["device"]) == {"platform", "kind", "count", "nvidia_smi"}
    assert rec["device"]["platform"] == "cpu"
    # 3 x 3 x 6 cells, f32
    assert rec["attempt_bytes"] == 59 * 54 * 4
    assert f"form {form}" in err


def test_refuses_to_run_without_a_gpu():
    """Without --platform the bench insists on a GPU and prints no
    record when JAX falls back to the CPU."""
    out = run_bench("--grid-nodes", "6", "--steps", "3", platform=())
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert out.stdout.strip() == ""


def test_attempt_bytes_from_shapes():
    sys.path.insert(0, REPO)
    import bench
    assert bench.attempt_planes() == 59
    # MR f32: 2 M cells -> 0.472 GB; HR f32: 16 M cells -> 3.78 GB
    assert bench.attempt_bytes(2_000_000, 4) == 472_000_000
    assert bench.attempt_bytes(16_000_000, 4) == 3_776_000_000
    h100 = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}
    assert bench.floor_ms(472_000_000, h100) == pytest.approx(0.1409, 1e-3)
    assert bench.floor_ms(1, {"platform": "cpu", "kind": "cpu"}) is None
    with pytest.raises(SystemExit, match="no peak bandwidth"):
        bench.floor_ms(1, {"platform": "gpu", "kind": "Some Other GPU"})


def test_kernel_breakdown_union_and_shares():
    """Busy time is the union of kernel intervals (overlapping streams
    count once); the idle share is measured against the traced window."""
    sys.path.insert(0, REPO)
    import bench
    # two attempts: kernels a (0-10, 20-30), b overlapping a (5-15), a
    # memcpy (40-45); window 0-45, busy 0-15 + 20-30 + 40-45 = 30
    events = [("a", 0, 10), ("b", 5, 10), ("a", 20, 10), ("MemcpyD2H", 40, 5)]
    r = bench.kernel_breakdown(events, attempts=2)
    assert r["busy_us_per_attempt"] == pytest.approx(30 / 2 / 1e3)
    assert r["window_us_per_attempt"] == pytest.approx(45 / 2 / 1e3)
    assert r["idle_share"] == pytest.approx(1 - 30 / 45)
    assert r["events_per_attempt"] == 2
    assert list(r["top_kernels_us_per_attempt"]) == ["a", "b", "MemcpyD2H"]
    assert bench.kernel_breakdown([], attempts=2) is None


def test_profiled_window_on_cpu_has_no_device_trace(tmp_path):
    """--profile-dir traces only the timed window; a CPU trace has no GPU
    plane, so the record carries no device breakdown."""
    prof = tmp_path / "prof"
    rec, _ = run_bench_ok("--grid-nodes", "6", "--steps", "3",
                          "--warm-steps", "3", "--profile-dir", str(prof))
    assert list(prof.glob("plugins/profile/*/*.xplane.pb"))
    assert rec["attempts_timed"] == 3
    assert rec["trace"] is None
