"""Round-3 noise-floor attribution (CPU, f64 arithmetic).

Loads the developed MR GradP frozen-bed checkpoint (snapshot 30 of the
round-3 golden run) and measures the Merson error estimate at a small
fixed h with SELECTIVE f32 rounding of the stage-state fields:

    eps(h) = max |0.2K1 - 0.9K3 + 0.8K4 - 0.1K5|

computed in f64 throughout, but with chosen fields of every stage input
rounded to f32 first.  As h -> 0 the true-error part vanishes ~h^4 while
rounding noise has an h-independent floor — so eps at tiny h IS the
floor, attributed per field.  Determines whether a double-f32 (or f64)
u alone would restore reference step counts at MR (round-4 design).

Usage: PYTHONPATH=. python scripts/repros/_r3_noise_floor_attribution.py <snapshot.ncd>
"""
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from porousfreezethaw.cases import freezing_params_text
from porousfreezethaw.config import parse_param_file
from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.io.netcdf3 import read_netcdf
from porousfreezethaw.models.freezing import FreezingParams, make_rhs

path = sys.argv[1]
data = read_netcdf(path)
u = np.asarray(data.variables["u"], np.float64)
p = np.asarray(data.variables["p"], np.float64)
gl = np.asarray(data.variables["gl"], np.float64)
w = jnp.asarray(np.stack([u, p, gl]))
t = float(data.attrs["t"])
n3, n2, n1 = u.shape
print(f"state {n1}x{n2}x{n3} at t={t:.1f}s  (u in [{u.min():.2f},{u.max():.2f}])")

pf = parse_param_file(freezing_params_text(grid_nodes=n3, calc_mode=0),
                     env={"OUTPUT": "/tmp"})
prm = FreezingParams.from_dict(pf.vars)
geom = GridGeometry(pf.vars["L1"], pf.vars["L2"], pf.vars["L3"], n1, n2, n3)
rhs = make_rhs(geom, prm, calc_mode=0)
delta = pf.vars["delta"]

U_STAR = prm.u_star  # f32 production stores u - u_star; round about it


def rounder(fields):
    def rnd(x):
        out = x
        if "u" in fields:
            ushift = (out[0] - U_STAR).astype(jnp.float32).astype(jnp.float64)
            out = out.at[0].set(ushift + U_STAR)
        if "p" in fields:
            out = out.at[1].set(
                out[1].astype(jnp.float32).astype(jnp.float64))
        if "gl" in fields:
            out = out.at[2].set(
                out[2].astype(jnp.float32).astype(jnp.float64))
        return out
    return rnd


@jax.jit
def eps_of(w, h, mode_u, mode_p, mode_gl):
    # selective rounding chosen by static booleans via closure re-trace
    pass  # replaced below


def attempt_eps(w, h, fields):
    rnd = rounder(fields)

    def f(ts, x):
        return rhs(ts, rnd(x))

    h3, h6, h8 = h / 3, h / 6, h / 8
    K1 = f(t, w)
    K2 = f(t + h3, w + h3 * K1)
    K3 = f(t + h3, w + h6 * (K1 + K2))
    K4 = f(t + h / 2, w + h8 * (K1 + 3 * K3))
    K5 = f(t + h, w + h * (0.5 * K1 - 1.5 * K3 + 2 * K4))
    return float(jnp.max(jnp.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5)))


print(f"delta = {delta:.1e}; controller fixed point 0.328*delta = "
      f"{0.328*delta:.2e}")
for h in (1e-3, 1e-4, 1e-5):
    row = {name: attempt_eps(w, h, fields) for name, fields in
           [("none(f64)", ()), ("u", ("u",)), ("p", ("p",)),
            ("u+p", ("u", "p")), ("u+p+gl", ("u", "p", "gl"))]}
    print(f"h={h:.0e}  " + "  ".join(f"{k}:{v:.3e}" for k, v in row.items()),
          flush=True)
