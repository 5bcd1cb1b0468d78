"""Process set-up shared by the apps, bench.py and chip_smoke.py: the
compile-cache location rule, and the smoke script's refusal to report
without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra, unset=(), cwd=REPO):
    env = dict(os.environ)
    for k in unset:
        env.pop(k, None)
    env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; without it the
    cache goes to the fixed <repo>/.jax_cache."""
    code = ("import jax\n"
            "from porousfreezethaw.core.runtime import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    if env_dir is None:
        out = _python(code, {}, unset=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        out = _python(code, {"JAX_COMPILATION_CACHE_DIR": want})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [want, want]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_needs_a_gpu(tmp_path, where):
    """No result line and a non-zero exit on the CPU, and in a directory
    that holds chip_smoke.py and nothing else of the repository."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    """Phases (a)-(d) of chip_smoke.py on the card (skips without one)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=1200,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
