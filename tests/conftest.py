"""Test configuration.

All tests run on CPU with 8 virtual devices (SURVEY §4: multi-device tests
via --xla_force_host_platform_device_count) and 64-bit mode enabled — the
reference's FLOAT default is double (include/common.h).

Tests marked ``gpu`` need an NVIDIA card; the ``gpu_card`` fixture skips
them where none is found (decided when the test runs, never at import, so
every xdist worker collects the same tests).  On the card they drive
``chip_smoke.py`` in a child process.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# the apps turn the persistent compilation cache on; tests compile fresh
# so that parallel workers never share cache files
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_card():
    """The card's ``name, power.limit`` line; skips without a card."""
    from porousfreezethaw.core.runtime import gpu_name_and_power_limit
    card = gpu_name_and_power_limit()
    if card is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")
    return card
