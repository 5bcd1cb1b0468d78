"""Round-5 probe: is the residual MR step inflation carried by the STATE?

_r5_delta_floor_attribution.py showed the delta estimator itself has no
f32 noise on the developed MR bed (f32 eps == f64 eps to 4 digits at
every h).  The remaining hypothesis for the 1.165x mid-freeze step
ratio: the per-step commit ``y <- fl32(y + dy)`` keeps the carried
state rough at the f32-ulp level, and the PDE's true local error on a
rough state is genuinely larger — the estimator is honest, the state is
noisy.

Test: from the SAME f32-valued checkpoint, evolve with the delta
attempt in f64 vs in f32 and compare accepted-step rates (steps per
simulated second == 1/mean accepted h).

* If f64-from-w32 quickly relaxes to a LOWER step rate than f32, the
  commit rounding is the driver -> a double-f32 (hi+lo) state carry is
  the fix (state 3->5 planes, K/update compensation).
* If both run at the same rate, the inflation is inherited roughness /
  genuine trajectory divergence, and double-f32 would buy nothing.

Usage: python scripts/repros/_r5_state_roughness_probe.py \
           <MR-GradP-delta run>/image.050.ncd [n_attempts]
"""
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from porousfreezethaw.cases import freezing_params_text
from porousfreezethaw.config import parse_param_file
from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.io.netcdf3 import read_netcdf
from porousfreezethaw.models.freezing import FreezingParams
from porousfreezethaw.models.freezing.delta import XlaDeltaAttempt
from porousfreezethaw.models.freezing.parameters import (
    shift_temperature_origin)
from porousfreezethaw.solvers.merson import (
    MersonParams, merson_init, merson_solve)

path = sys.argv[1]
n_attempts = int(sys.argv[2]) if len(sys.argv) > 2 else 600
data = read_netcdf(path)
u = np.asarray(data.variables["u"], np.float64)
p = np.asarray(data.variables["p"], np.float64)
gl = np.asarray(data.variables["gl"], np.float64)
t0 = float(data.attrs["t"])
tau = float(data.attrs["tau"])
n3, n2, n1 = u.shape
print(f"state {n1}x{n2}x{n3} at t={t0:.1f}s, checkpoint tau={tau:.3e}")

# params from the checkpoint's own attrs (the shipped Params, not the
# bench case generator — they differ in xi_gl)
prm0 = FreezingParams.from_dict(data.attrs)
geom = GridGeometry(data.attrs["L1"], data.attrs["L2"], data.attrs["L3"],
                    n1, n2, n3)
prm = shift_temperature_origin(prm0, prm0.u_star)
delta = float(data.attrs["delta"])

w32 = np.stack([(u - prm0.u_star).astype(np.float32).astype(np.float64),
                p.astype(np.float32).astype(np.float64),
                gl.astype(np.float32).astype(np.float64)])

params = MersonParams(delta=delta, h_min=1e-6)

for name, dtype in (("f64", jnp.float64), ("f32", jnp.float32)):
    att = XlaDeltaAttempt(geom, prm, calc_mode=0)
    w = jnp.asarray(w32, dtype)
    st = merson_init(w, t0, tau)
    chunk = 200
    solve = jax.jit(lambda s: merson_solve(
        lambda *a: None, s, 1e9,
        MersonParams(delta=delta, h_min=params.h_min, max_steps=chunk),
        attempt_fn=att))
    done = 0
    tick = time.time()
    while done < n_attempts:
        st, _ = solve(st)
        done = int(st.steps_total)
        dt_sim = float(st.t) - t0
        print(f"  [{name}] attempts={done} steps={int(st.steps)} "
              f"t-t0={dt_sim:.4f}s h={float(st.h):.3e} "
              f"steps/simsec={int(st.steps)/max(dt_sim,1e-12):.1f} "
              f"({time.time()-tick:.0f}s wall)", flush=True)
