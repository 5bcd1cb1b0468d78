"""Floating-point precision policy.

The reference's ``FLOAT`` compile-time precision switch
(``include/common.h:11-26``: float / double / long double, default double)
becomes a runtime dtype policy here.  All solver and model code takes the
dtype from its input arrays; this module only holds the process-wide default
used when building initial states and constants.

The validation path (matching the reference's double-precision results)
runs in float64; the f32 production path of the intertrack app runs
float32 fields with float64 controller scalars.  ``enable_x64()`` must be
called before any jax array is created if float64 state is desired.
"""

from __future__ import annotations

import jax
import numpy as np

_DEFAULT_DTYPE = np.float64


def enable_x64() -> None:
    """Enable 64-bit mode in JAX (the reference's default FLOAT=double)."""
    jax.config.update("jax_enable_x64", True)


def set_default_dtype(dtype) -> None:
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = np.dtype(dtype).type
    if _DEFAULT_DTYPE == np.float64:
        enable_x64()


def default_dtype():
    """Current default floating dtype for new simulation states.

    Falls back to float32 when float64 was requested but x64 mode is off,
    mirroring JAX's own demotion behaviour explicitly.
    """
    if _DEFAULT_DTYPE == np.float64 and not jax.config.read("jax_enable_x64"):
        return np.float32
    return _DEFAULT_DTYPE
