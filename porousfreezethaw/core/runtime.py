"""Process-level JAX set-up shared by the apps, bench.py and chip_smoke.py:
where compiled programs are cached, and which device a run used."""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    The path is part of the cache key, so the default never moves."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache.  When the environment
    variable is set JAX reads it itself and nothing is overridden."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> Optional[str]:
    """The card's ``name, power.limit`` line from nvidia-smi, or None
    where there is no NVIDIA driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[0].strip()


def device_record() -> Dict[str, object]:
    """What a measurement ran on: JAX's platform, device kind and device
    count, plus the card's name and power limit from nvidia-smi."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power_limit()}
