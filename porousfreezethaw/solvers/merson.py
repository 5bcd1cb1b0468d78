"""Adaptive Runge-Kutta-Merson time integrator.

A re-design of the reference solver family
``modules/RK_Asolver`` (serial) and ``modules/RK_MPI_SAsolver{,_hybrid,
_hybrid2}`` (MPI / hybrid): one integrator over arbitrary JAX pytrees,
expressed as a ``lax.while_loop`` so the entire adaptive stepping between
two output times runs on-device in a single compiled call.

Numerics replicated exactly (RK_Asolver.c:202-294, RK_MPI_SAsolver.c:330-660):

    K1 = f(t,       x)
    K2 = f(t+h/3,   x + (h/3) K1)
    K3 = f(t+h/3,   x + (h/6)(K1+K2))
    K4 = f(t+h/2,   x + (h/8)(K1+3 K3))
    K5 = f(t+h,     x + h (0.5 K1 - 1.5 K3 + 2 K4))
    eps   = max |0.2 K1 - 0.9 K3 + 0.8 K4 - 0.1 K5| * eps_mult   (max norm)
    eps  *= |h/3|                 if delta_mode == 'local'
    new_h = 0.8 (delta/eps)^0.2 h  (eps>0);  2 h if eps == 0
    accept iff eps < delta or |h| < h_min
    update  x += (h/3) ((K1+K5)/2 + 2 K4);  t += h
    NaN backoff (opt-in): h /= 10, abort when h/(T-t) < 1e-11
    final-step trimming: h clamped to final_time - t; the *untrimmed*
      estimate is preserved for seamless continuation across calls

Where the reference keeps program-flow consistency by making every
floating-point control decision on the master rank and broadcasting a
command bitmask (RK_MPI_SAsolver.c:320-331, the RKA_CMD_* protocol), here
SPMD + deterministic XLA collectives give every device identical scalars by
construction: the error maximum over a sharded state is a single global
``jnp.max`` (an all-reduce over the mesh) and the accept/reject branch is
computed redundantly-but-identically on all devices.  The chunked sparse
memory layout (RK_MEM_DIST) disappears: ghost cells are simply not part of
the state pytree, and per-chunk ``chunk_eps_mult`` becomes an optional
per-leaf ``eps_mult`` pytree.

The reference's service callback (debug RK log, on-demand snapshot
triggering — intertrack.c:1072-1116) is supported through
``jax.experimental.io_callback``: it runs on the host after every accepted
step and its return value can interrupt the solve (status
``INTERRUPTED``), matching RKA_CMD_BREAK semantics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax, tree_util
from jax.experimental import io_callback as _io_callback


# status codes (mirroring the reference return codes where they exist)
OK = 0            # reached final_time
INTERRUPTED = 1   # service callback requested a break (RKA_CMD_BREAK)
NAN_ABORT = -4    # NaN backoff failed (reference -4)
MAX_STEPS = -7    # safety bound hit (no reference analog: the C solver loops forever)


class MersonState(NamedTuple):
    """Integration state carried across ``merson_solve`` calls — the
    RK_MPI_S_SOLUTION fields t / h / steps / steps_total
    (include/RK_MPI_SAsolver.h:196-289)."""

    t: jax.Array
    h: jax.Array
    y: Any                 # solution pytree
    steps: jax.Array       # successful steps
    steps_total: jax.Array # attempted steps


@dataclasses.dataclass(frozen=True)
class MersonParams:
    """Step-control parameters (RK_MPI_S_SOLUTION: h_min, delta, delta_mode)."""

    delta: float
    h_min: float = 0.0
    delta_mode: str = "global"     # 'global' (both reference apps) or 'local'
    handle_nan: bool = False
    max_steps: int = 2**62         # safety bound on attempted steps per call
    record_trace: int = 0          # record (t, h) of up to N accepted steps;
                                   # the host-callback-free way to drive the
                                   # RK debug log under a mesh, where an
                                   # io_callback cannot be partitioned
    accept_growth_min: float = 0.0  # if > 1: minimum h-growth factor on
                                   # ACCEPTED steps.  The reference growth
                                   # rule 0.8*(delta/eps)^0.2 has its fixed
                                   # point at eps = 0.328*delta; an
                                   # h-independent error-estimator noise
                                   # floor at/above that value pins h there
                                   # forever (measured for f32 GradP fields:
                                   # stage-state rounding ulp(u)*|J| ~
                                   # 3.5e-4 vs delta = 1e-3, ~3-10x step
                                   # inflation).  A floor of ~1.05 lets h
                                   # climb out of the noise-dominated regime
                                   # and equilibrate through genuine rejects
                                   # (~1 per 5-6 accepts) at the true-error
                                   # crossing.  Off (0.0) for f64 validation
                                   # runs: exact reference step sequences.


def _scalar_dtype(field_dtype):
    """Controller scalars (t, h, eps) run in f64 whenever x64 is enabled,
    even for f32 fields: f32 time accumulation breaks down over the
    reference's 36000 s runs (ulp(36000) in f32 is ~4 ms vs steps ~20 ms),
    and the accept/reject comparison deserves the extra headroom."""
    if jax.config.read("jax_enable_x64"):
        return jnp.float64
    return field_dtype


def merson_init(y0, t0=0.0, h0=1.0) -> MersonState:
    leaves = tree_util.tree_leaves(y0)
    dtype = leaves[0].dtype if hasattr(leaves[0], "dtype") else jnp.result_type(float)
    sdtype = _scalar_dtype(dtype)
    return MersonState(
        t=jnp.asarray(t0, sdtype),
        h=jnp.asarray(h0, sdtype),
        y=y0,
        steps=jnp.asarray(0, jnp.int64 if jax.config.read("jax_enable_x64") else jnp.int32),
        steps_total=jnp.asarray(0, jnp.int64 if jax.config.read("jax_enable_x64") else jnp.int32),
    )


def nan_max(x):
    """``jnp.max`` that keeps a NaN when ``x`` is sharded over GPUs.

    A sharded max lowers to a max all-reduce, and NCCL's max drops NaN
    operands: a NaN on one shard would vanish from the error estimate and
    a poisoned step could be accepted.  The NaN flag is reduced on its own
    (an integer reduction, exact everywhere), so the result is NaN exactly
    when ``x`` holds one, as on a single device."""
    return jnp.where(jnp.any(jnp.isnan(x)), jnp.asarray(jnp.nan, x.dtype),
                     jnp.max(x))


def _tree_axpy(a, x, y):
    """y + a*x over pytrees (the solver's chunk axpy sweeps).  The scalar
    is cast to the leaf dtype so f64 control scalars never upcast f32
    fields."""
    return tree_util.tree_map(
        lambda xi, yi: yi + jnp.asarray(a, xi.dtype) * xi, x, y)


def merson_solve(
    rhs: Callable[[jax.Array, Any], Any],
    state: MersonState,
    final_time,
    params: MersonParams,
    eps_mult: Any = None,
    service_callback: Optional[Callable] = None,
    attempt_fn: Optional[Any] = None,
):
    """Integrate ``state`` to ``final_time``; returns ``(state, status)``.

    ``rhs(t, y) -> dy/dt`` operates on the full pytree.  ``eps_mult`` is an
    optional pytree of per-leaf error multipliers (chunk_eps_mult).  The
    whole accept/reject loop is a single ``lax.while_loop`` and is jittable
    (and shardable: sharded leaves make the error max a mesh all-reduce).

    ``service_callback(t, h, steps) -> int`` (host code) is invoked after
    every accepted step; a nonzero return interrupts the solve, which then
    returns ``status == INTERRUPTED`` with a valid continuation ``h``
    (RK_MPI_SAsolver.c:578-601).

    ``attempt_fn`` (e.g. models.freezing.delta.XlaDeltaAttempt) replaces
    the five ``rhs`` stages: ``attempt_fn.attempt(t, h, y) -> (carry,
    eps_blocks)`` computes one attempt and its error blocks, and
    ``attempt_fn.commit(carry, accept) -> y`` applies or drops the
    update; ``rhs`` is then unused and ``eps_mult`` is unsupported.
    """
    leaves = tree_util.tree_leaves(state.y)
    dtype = leaves[0].dtype
    sdtype = _scalar_dtype(dtype)
    tf = jnp.asarray(final_time, sdtype)
    delta = jnp.asarray(params.delta, sdtype)
    h_min = jnp.asarray(params.h_min, sdtype)
    local_mode = params.delta_mode == "local"

    t0, h0 = state.t.astype(sdtype), state.h.astype(sdtype)

    # --- prologue: reverse h toward final_time; pre-truncate the first step
    # (RK_MPI_SAsolver.c:300-307) ---
    h_rev = jnp.where((tf > t0) & (h0 < 0) | (tf < t0) & (h0 > 0), -h0, h0)
    prefinished = (h_rev == 0) | (jnp.abs(tf - t0) <= jnp.abs(h_rev))
    h_start = jnp.where(prefinished, tf - t0, h_rev)
    # continuation h: stays at the (reversed) input value unless a
    # NEXTFINISH saves a fresh untrimmed estimate
    h_cont0 = h_rev

    if attempt_fn is not None and eps_mult is not None:
        raise ValueError("eps_mult is not supported with attempt_fn")

    if eps_mult is None:
        eps_mult = tree_util.tree_map(lambda _: jnp.asarray(1.0, dtype), state.y)

    def _eps_of(K1, K3, K4, K5):
        def leaf_eps(k1, k3, k4, k5, m):
            return nan_max(m * jnp.abs(0.2 * k1 - 0.9 * k3 + 0.8 * k4 - 0.1 * k5))
        per_leaf = tree_util.tree_map(leaf_eps, K1, K3, K4, K5, eps_mult)
        return tree_util.tree_reduce(jnp.maximum, per_leaf)

    if service_callback is not None:
        def _host_service(t, h, steps):
            return jnp.int32(service_callback(float(t), float(h), int(steps)))

        def call_service(t, h, steps):
            return _io_callback(
                _host_service, jax.ShapeDtypeStruct((), jnp.int32),
                t, h, steps, ordered=True)
    else:
        call_service = None

    start_total = state.steps_total
    # clamp to the counter width (int32 when x64 is off: the default
    # 2**62 sentinel would overflow the comparison)
    max_steps = min(params.max_steps,
                    2**62 if jax.config.read("jax_enable_x64") else 2**31 - 1)

    def cond_fun(carry):
        steps_total, done = carry[5], carry[7]
        # max_steps bounds the attempts of THIS call, not the lifetime count
        return ~done & (steps_total - start_total < max_steps)

    def body_fun(carry):
        (t, h, h_cont, y, steps, steps_total, finished, done, status,
         trace) = carry
        h2, h3, h6, h8 = h / 2, h / 3, h / 6, h / 8

        if attempt_fn is not None:
            carry_spec, eps_blocks = attempt_fn.attempt(t, h, y)
        else:
            K1 = rhs(t, y)
            K2 = rhs(t + h3, _tree_axpy(h3, K1, y))
            K3 = rhs(t + h3, _tree_axpy(h6, tree_util.tree_map(jnp.add, K1, K2), y))
            K4 = rhs(t + h2, _tree_axpy(
                h8, tree_util.tree_map(lambda a, b: a + 3.0 * b, K1, K3), y))
            K5 = rhs(t + h, _tree_axpy(
                h, tree_util.tree_map(
                    lambda a, b, c: 0.5 * a - 1.5 * b + 2.0 * c, K1, K3, K4), y))

        steps_total = steps_total + 1
        if attempt_fn is not None:
            eps = jnp.max(eps_blocks)
        else:
            eps = _eps_of(K1, K3, K4, K5)
        if local_mode:
            eps = eps * jnp.abs(h3)

        eps = eps.astype(sdtype)
        fac = jnp.where(eps > 0.0,
                        0.8 * (delta / eps) ** jnp.asarray(0.2, sdtype),
                        jnp.asarray(2.0, sdtype))

        nan_occurred = ~jnp.isfinite(eps) if params.handle_nan else jnp.asarray(False)
        accept = (eps < delta) | (jnp.abs(h) < h_min)

        if params.accept_growth_min > 1.0:
            # noise-floor escape (see MersonParams.accept_growth_min):
            # genuinely accepted steps (eps < delta) grow h by at least
            # this factor; rejected steps and h_min-forced accepts
            # (|h| < h_min with eps >= delta) keep the pure reference
            # shrink — growing h on a step whose error already exceeds
            # tolerance would make h oscillate around h_min instead of
            # the reference's monotone shrink
            fac = jnp.where(eps < delta,
                            jnp.maximum(fac, jnp.asarray(
                                params.accept_growth_min, sdtype)),
                            fac)
        new_h = fac * h

        # --- accepted-step update (only where accept & ~nan) ---
        do_update = accept & ~nan_occurred
        if attempt_fn is not None:
            y_new = attempt_fn.commit(carry_spec, do_update)
        else:
            y_new = tree_util.tree_map(
                lambda yi, k1, k4, k5: jnp.where(
                    do_update,
                    yi + jnp.asarray(h3, yi.dtype) * (0.5 * (k1 + k5) + 2.0 * k4),
                    yi),
                y, K1, K4, K5)
        t_new = jnp.where(do_update, t + h, t)
        steps_new = jnp.where(do_update, steps + 1, steps)

        if call_service is not None:
            svc = lax.cond(do_update,
                           lambda: call_service(t_new, h, steps_new),
                           lambda: jnp.int32(0))
        else:
            svc = jnp.int32(0)
        svc_break = svc != 0

        # --- NaN backoff (RK_MPI_SAsolver.c:541-551) ---
        h_too_small = jnp.abs(h / (tf - t)) < 1e-11
        nan_abort = nan_occurred & h_too_small

        # --- last-step management (NEXTFINISH, RK_MPI_SAsolver.c:606-648) ---
        next_finish = jnp.abs(tf - t_new) <= jnp.abs(new_h)

        done_new = (do_update & (finished | svc_break)) | nan_abort
        status_new = jnp.where(
            nan_abort, NAN_ABORT,
            jnp.where(do_update & svc_break & ~finished, INTERRUPTED, status))

        # next h: NaN -> h/10 ; accepted+next_finish -> trimmed; else new_h
        h_next = jnp.where(
            nan_occurred, h / 10.0,
            jnp.where(do_update & next_finish, tf - t_new, new_h))
        h_cont_next = jnp.where(do_update & next_finish & ~done_new, new_h, h_cont)
        # interrupted: continue later from new_h (system->h=new_h on BREAK)
        h_cont_next = jnp.where(do_update & svc_break & ~finished, new_h, h_cont_next)
        finished_next = jnp.where(nan_occurred, False,
                                  jnp.where(do_update, next_finish, False))

        if params.record_trace:
            idx = jnp.clip(steps_new - state.steps - 1, 0,
                           params.record_trace - 1)
            t_tr, h_tr = trace
            t_tr = jnp.where(do_update, t_tr.at[idx].set(t_new), t_tr)
            h_tr = jnp.where(do_update, h_tr.at[idx].set(h), h_tr)
            trace = (t_tr, h_tr)

        return (t_new, h_next, h_cont_next, y_new, steps_new, steps_total,
                finished_next, done_new, status_new, trace)

    trace0 = (jnp.zeros((params.record_trace,), sdtype),
              jnp.zeros((params.record_trace,), sdtype)) \
        if params.record_trace else ()
    carry0 = (
        t0, h_start, h_cont0, state.y,
        state.steps, state.steps_total,
        prefinished, jnp.asarray(False), jnp.asarray(OK, jnp.int32),
        trace0,
    )
    (t, h_work, h_cont, y, steps, steps_total, _fin, done, status,
     trace) = lax.while_loop(cond_fun, body_fun, carry0)

    status = jnp.where(done, status, jnp.asarray(MAX_STEPS, jnp.int32))
    # normal exits continue from the untrimmed estimate; a max_steps exit
    # must resume from the current working step
    h_out = jnp.where(done, h_cont, h_work)
    new_state = MersonState(t=t, h=h_out, y=y, steps=steps, steps_total=steps_total)
    if params.record_trace:
        return new_state, status, trace
    return new_state, status


def merson_solve_jit(rhs, params: MersonParams, eps_mult=None, service_callback=None):
    """Convenience: a jitted ``(state, final_time) -> (state, status)``."""
    fn = functools.partial(
        merson_solve, rhs, params=params, eps_mult=eps_mult,
        service_callback=service_callback)
    return jax.jit(lambda state, final_time: fn(state, final_time))
