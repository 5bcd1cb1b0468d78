"""Tests for the Merson adaptive solver against analytic ODEs and an
independent NumPy transcription of the reference algorithm's semantics
(RK_Asolver.c / RK_MPI_SAsolver.c)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.solvers import (
    MersonParams, merson_init, merson_solve, rk4_solve)
from porousfreezethaw.solvers import merson as merson_mod


def numpy_merson_reference(f, t, y, tf, h, delta, h_min=0.0, max_iter=100000):
    """Plain-python Merson controller implementing the documented reference
    semantics (SURVEY §2.1 numerics block) as an independent oracle.
    Returns (t, y, h_cont, steps, steps_total, trace) where trace is the
    list of (t, h) after each successful step."""
    y = np.array(y, dtype=np.float64)
    trace = []
    steps = steps_total = 0
    # prologue
    if (tf > t and h < 0) or (tf < t and h > 0):
        h = -h
    finished = False
    h_cont = h
    if h == 0 or abs(tf - t) <= abs(h):
        h = tf - t
        finished = True
    for _ in range(max_iter):
        h3 = h / 3.0
        K1 = f(t, y)
        K2 = f(t + h3, y + h3 * K1)
        K3 = f(t + h3, y + (h / 6.0) * (K1 + K2))
        K4 = f(t + h / 2.0, y + (h / 8.0) * (K1 + 3.0 * K3))
        K5 = f(t + h, y + h * (0.5 * K1 - 1.5 * K3 + 2.0 * K4))
        steps_total += 1
        eps = np.max(np.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5))
        new_h = (0.8 * (delta / eps) ** 0.2 if eps > 0 else 2.0) * h
        if eps < delta or abs(h) < h_min:
            y = y + h3 * (0.5 * (K1 + K5) + 2.0 * K4)
            t = t + h
            steps += 1
            trace.append((t, h))
            if finished:
                break
            if abs(tf - t) <= abs(new_h):
                h_cont = new_h
                h = tf - t
                finished = True
            else:
                h = new_h
        else:
            h = new_h
            finished = False
    return t, y, h_cont, steps, steps_total, trace


def solve_jax(f, t, y, tf, h, delta, h_min=0.0, **kw):
    state = merson_init(jnp.asarray(y, jnp.float64), t, h)
    params = MersonParams(delta=delta, h_min=h_min, **kw)
    new_state, status = jax.jit(
        lambda s: merson_solve(f, s, tf, params))(state)
    return new_state, int(status)


class TestAnalytic:
    def test_exponential_decay(self):
        # y' = -y, y(0)=1 -> y(1)=e^-1
        f = lambda t, y: -y
        st, status = solve_jax(f, 0.0, [1.0], 1.0, 0.1, delta=1e-8)
        assert status == 0
        assert float(st.t) == pytest.approx(1.0, abs=1e-14)
        assert float(st.y[0]) == pytest.approx(math.exp(-1.0), rel=1e-8)
        assert int(st.steps) >= 1
        assert int(st.steps_total) >= int(st.steps)

    def test_harmonic_oscillator(self):
        # y'' = -y as a 2-system; y(0)=1, y'(0)=0 -> y(2pi)=1
        f = lambda t, y: jnp.stack([y[1], -y[0]])
        st, status = solve_jax(f, 0.0, [1.0, 0.0], 2 * math.pi, 0.1, delta=1e-9)
        assert status == 0
        assert float(st.y[0]) == pytest.approx(1.0, abs=1e-6)
        assert float(st.y[1]) == pytest.approx(0.0, abs=1e-6)

    def test_polynomial_exact(self):
        # RK4 is exact for cubic polynomials: y' = 3t^2 -> y = t^3
        f = lambda t, y: jnp.full_like(y, 3.0 * t**2)
        st, status = solve_jax(f, 0.0, [0.0], 2.0, 0.5, delta=1e-4)
        assert status == 0
        assert float(st.y[0]) == pytest.approx(8.0, rel=1e-12)

    def test_backward_integration(self):
        # integrate from t=1 back to t=0 (automatic h reversal)
        f = lambda t, y: -y
        st, status = solve_jax(f, 1.0, [math.exp(-1.0)], 0.0, 0.1, delta=1e-8)
        assert status == 0
        assert float(st.y[0]) == pytest.approx(1.0, rel=1e-7)

    def test_pytree_state(self):
        f = lambda t, y: {"a": -y["a"], "b": 2.0 * jnp.ones_like(y["b"])}
        y0 = {"a": jnp.ones((3,), jnp.float64), "b": jnp.zeros((2,), jnp.float64)}
        state = merson_init(y0, 0.0, 0.1)
        st, status = merson_solve(f, state, 1.0, MersonParams(delta=1e-8))
        assert int(status) == 0
        np.testing.assert_allclose(st.y["a"], math.exp(-1.0), rtol=1e-8)
        np.testing.assert_allclose(st.y["b"], 2.0, rtol=1e-12)


class TestReferenceSemantics:
    """The jitted while_loop must reproduce the exact accept/reject and
    step-size sequence of the reference algorithm (independent NumPy
    transcription), including step counts — the reference logs prove step
    counts are rank-invariant, making them a cross-implementation oracle
    (BASELINE.md)."""

    @pytest.mark.parametrize("delta,h0", [(1e-3, 0.5), (1e-6, 0.1), (1e-2, 2.0)])
    def test_step_sequence_matches(self, delta, h0):
        fn = lambda t, y: np.array([y[1], (1 - y[0] ** 2) * y[1] - y[0]])
        fj = lambda t, y: jnp.stack([y[1], (1 - y[0] ** 2) * y[1] - y[0]])
        t_r, y_r, h_r, steps_r, tot_r, _ = numpy_merson_reference(
            fn, 0.0, [2.0, 0.0], 5.0, h0, delta)
        st, status = solve_jax(fj, 0.0, [2.0, 0.0], 5.0, h0, delta=delta)
        assert status == 0
        assert int(st.steps) == steps_r
        assert int(st.steps_total) == tot_r
        np.testing.assert_allclose(np.asarray(st.y), y_r, rtol=1e-8, atol=1e-10)
        assert float(st.h) == pytest.approx(h_r, rel=1e-12)

    def test_zero_interval_counts_one_step(self):
        # solve(t -> t) performs exactly one (no-op) accepted step, like the
        # reference's pre-truncated FINISHED path (RK_MPI_SAsolver.c:300-307)
        f = lambda t, y: -y
        st, status = solve_jax(f, 0.0, [1.0], 0.0, 0.25, delta=1e-6)
        assert status == 0
        assert int(st.steps) == 1 and int(st.steps_total) == 1
        assert float(st.y[0]) == 1.0
        assert float(st.h) == 0.25  # continuation h untouched

    def test_continuation_across_snapshots(self):
        # two back-to-back solves must equal one long solve in step counts
        # (seamless continuation via the untrimmed h, RK_MPI_SAsolver.h:68-71)
        fn = lambda t, y: np.array([-10.0 * y[0] + np.sin(t)])
        fj = lambda t, y: -10.0 * y + jnp.sin(t)

        t_r, y_r, h_r, s_r, st_r, _ = numpy_merson_reference(
            fn, 0.0, [1.0], 1.0, 0.1, 1e-6)
        t_r, y_r, h_r, s_r2, st_r2, _ = numpy_merson_reference(
            fn, t_r, y_r, 2.0, h_r, 1e-6)

        params = MersonParams(delta=1e-6)
        state = merson_init(jnp.asarray([1.0], jnp.float64), 0.0, 0.1)
        state, _ = merson_solve(fj, state, 1.0, params)
        state, _ = merson_solve(fj, state, 2.0, params)
        assert int(state.steps) == s_r + s_r2
        np.testing.assert_allclose(np.asarray(state.y), y_r, rtol=1e-8)

    def test_h_min_forces_accept(self):
        # with h_min large, every step is accepted regardless of eps
        fj = lambda t, y: -1000.0 * y
        st, status = solve_jax(fj, 0.0, [1.0], 0.002, 0.001, delta=1e-7,
                               h_min=1.0)
        assert status == 0
        assert int(st.steps) == int(st.steps_total)
        # and rejections do occur for the same setup when h_min is small
        st2, status2 = solve_jax(fj, 0.0, [1.0], 0.002, 0.001, delta=1e-7,
                                 h_min=0.0)
        assert int(st2.steps_total) > int(st2.steps)

    def test_delta_local_mode(self):
        fn = lambda t, y: np.array([y[1], -y[0]])
        fj = lambda t, y: jnp.stack([y[1], -y[0]])

        # local mode multiplies eps by |h/3| before control (SAsolver.c:499)
        def numpy_local(t, y, tf, h, delta):
            y = np.array(y)
            steps = 0
            finished = False
            if abs(tf - t) <= abs(h):
                h, finished = tf - t, True
            for _ in range(10000):
                h3 = h / 3
                K1 = fn(t, y); K2 = fn(t + h3, y + h3 * K1)
                K3 = fn(t + h3, y + h / 6 * (K1 + K2))
                K4 = fn(t + h / 2, y + h / 8 * (K1 + 3 * K3))
                K5 = fn(t + h, y + h * (0.5 * K1 - 1.5 * K3 + 2 * K4))
                eps = np.max(np.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5))
                eps *= abs(h3)
                new_h = (0.8 * (delta / eps) ** 0.2 if eps > 0 else 2.0) * h
                if eps < delta:
                    y = y + h3 * (0.5 * (K1 + K5) + 2 * K4); t += h; steps += 1
                    if finished:
                        break
                    if abs(tf - t) <= abs(new_h):
                        h, finished = tf - t, True
                    else:
                        h = new_h
                else:
                    h, finished = new_h, False
            return steps, y

        s_ref, y_ref = numpy_local(0.0, [1.0, 0.0], 3.0, 0.5, 1e-7)
        st, status = solve_jax(fj, 0.0, [1.0, 0.0], 3.0, 0.5, delta=1e-7,
                               delta_mode="local")
        assert status == 0
        assert int(st.steps) == s_ref
        np.testing.assert_allclose(np.asarray(st.y), y_ref, rtol=1e-8)

    def test_eps_mult(self):
        # doubling eps_mult must behave like halving delta
        fj = lambda t, y: jnp.stack([y[1], -y[0]])
        st1, _ = solve_jax(fj, 0.0, [1.0, 0.0], 3.0, 0.5, delta=1e-6)
        y0 = jnp.asarray([1.0, 0.0], jnp.float64)
        state = merson_init(y0, 0.0, 0.5)
        st2, _ = merson_solve(fj, state, 3.0, MersonParams(delta=2e-6),
                              eps_mult=jnp.asarray(2.0, jnp.float64))
        assert int(st1.steps_total) == int(st2.steps_total)


class TestNaNHandling:
    def test_nan_backoff_recovers(self):
        # a singular RHS that yields NaN for big steps but works for small
        def fj(t, y):
            # sqrt of a quantity that goes negative if the stage leaves [0,2]
            return jnp.sqrt(2.0 - y) * 0.0 - y
        st, status = solve_jax(fj, 0.0, [1.0], 1.0, 50.0, delta=1e-6,
                               handle_nan=True)
        # step starts way too large (h=50 > interval): pre-truncated; fine
        assert status == 0

    def test_nan_abort(self):
        fj = lambda t, y: y * jnp.nan
        st, status = solve_jax(fj, 0.0, [1.0], 1.0, 0.5, delta=1e-6,
                               handle_nan=True)
        assert status == merson_mod.NAN_ABORT

    def test_max_steps_guard(self):
        fj = lambda t, y: -y
        state = merson_init(jnp.asarray([1.0], jnp.float64), 0.0, 1e-9)
        st, status = merson_solve(fj, state, 1.0,
                                  MersonParams(delta=1e-30, h_min=0.0,
                                               max_steps=50))
        assert int(status) == merson_mod.MAX_STEPS


class TestServiceCallback:
    def test_callback_called_per_accepted_step(self):
        calls = []

        def svc(t, h, steps):
            calls.append((t, h, steps))
            return 0

        fj = lambda t, y: -y
        state = merson_init(jnp.asarray([1.0], jnp.float64), 0.0, 0.1)
        st, status = merson_solve(fj, state, 1.0, MersonParams(delta=1e-6),
                                  service_callback=svc)
        jax.block_until_ready(st.y)
        assert int(status) == 0
        assert len(calls) == int(st.steps)
        assert calls[-1][2] == int(st.steps)

    def test_callback_break_interrupts(self):
        def svc(t, h, steps):
            return 1 if steps >= 3 else 0

        fj = lambda t, y: -y
        state = merson_init(jnp.asarray([1.0], jnp.float64), 0.0, 0.01)
        st, status = merson_solve(fj, state, 5.0, MersonParams(delta=1e-10),
                                  service_callback=svc)
        assert int(status) == merson_mod.INTERRUPTED
        assert int(st.steps) == 3
        assert float(st.t) < 5.0
        # the solve can be resumed
        st2, status2 = merson_solve(fj, st, 5.0, MersonParams(delta=1e-10))
        assert int(status2) == 0
        assert float(st2.t) == pytest.approx(5.0)


class TestRK4:
    def test_fixed_step_exact_cubic(self):
        f = lambda t, y: jnp.full_like(y, 3.0 * t**2)
        t, y = rk4_solve(f, 0.0, jnp.zeros((1,), jnp.float64), 0.25, 8)
        assert float(t) == pytest.approx(2.0)
        assert float(y[0]) == pytest.approx(8.0, rel=1e-12)

    def test_decay_order4(self):
        f = lambda t, y: -y
        errs = []
        for n in (16, 32):
            t, y = rk4_solve(f, 0.0, jnp.ones((1,), jnp.float64), 1.0 / n, n)
            errs.append(abs(float(y[0]) - math.exp(-1.0)))
        assert errs[0] / errs[1] > 12  # ~16 for 4th order


class TestMixedPrecision:
    def test_f32_fields_f64_scalars(self):
        # with x64 on, f32 fields keep their dtype while t/h run in f64
        # (f32 time accumulation breaks over the reference's 36000s runs)
        fj = lambda t, y: -y
        y0 = jnp.ones((4,), jnp.float32)
        state = merson_init(y0, 0.0, 0.1)
        assert state.t.dtype == jnp.float64
        assert state.h.dtype == jnp.float64
        st, status = merson_solve(fj, state, 1.0, MersonParams(delta=1e-4))
        assert int(status) == 0
        assert st.y.dtype == jnp.float32
        assert st.t.dtype == jnp.float64
        assert float(st.y[0]) == pytest.approx(math.exp(-1.0), rel=1e-3)

    def test_large_t_accumulation(self):
        # t ~ 36000 with small h: representable exactly in f64 scalars
        fj = lambda t, y: jnp.zeros_like(y)
        y0 = jnp.ones((2,), jnp.float32)
        state = merson_init(y0, 36000.0, 0.005)
        st, status = merson_solve(fj, state, 36000.1,
                                  MersonParams(delta=1e-6))
        assert int(status) == 0
        assert float(st.t) == pytest.approx(36000.1, abs=1e-9)


class TestOverflowRecovery:
    def test_f32_overflow_cold_start_recovers_with_handle_nan(self):
        """An f32 stage cascade that overflows at the initial h (the MR
        GradP tau=1 cold start) must recover via the NaN backoff
        (RK_Asolver.c:96-131).  Without it, eps=inf drives the growth
        factor to 0 and h spins at exactly 0 forever (the reference
        loops forever there too, and an on-device loop never returns),
        which is why the intertrack app enables handle_nan for f32
        runs."""
        # stiff decay: at h=1 the K cascade amplifies ~(h*k)^4*k ~ 1e40,
        # overflowing f32 through the stage-5 combination.  delta sits
        # above the f32 estimator noise floor k*ulp(y) ~ 12 (like the
        # production case, where the floor is below delta), so once the
        # backoff has recovered a finite h the controller steps normally.
        k = 1e8
        f = lambda t, y: -k * y
        y0 = jnp.ones((4,), jnp.float32)
        params = MersonParams(delta=100.0, h_min=1e-12, max_steps=500,
                              handle_nan=True)
        state = merson_init(y0, 0.0, 1.0)
        # tf far beyond reach: the point is the recovery, not completion
        st, status = jax.jit(
            lambda s: merson_solve(f, s, 1.0, params))(state)
        assert int(st.steps) >= 1          # accepted steps happened
        assert float(st.t) > 0.0           # time advanced
        h = float(jnp.abs(st.h))
        assert np.isfinite(h) and h > 0.0  # h recovered to an equilibrium
        assert np.all(np.isfinite(np.asarray(st.y)))

    def test_zero_h_trap_needs_handle_nan(self):
        """When the stage cascade overflows to eps = +inf, the reference
        growth rule pow(delta/inf, 0.2) = 0 makes new_h = 0 — and at
        h = 0 every subsequent attempt keeps h at exactly 0 (fac * 0),
        rejecting forever: reference-parity behavior where the C solver
        loops forever (and an on-device loop never returns).
        handle_nan's h/10 backoff takes precedence over the zero growth
        factor and escapes the trap."""
        k = 1e12
        f = lambda t, y: -k * y
        y0 = jnp.full((4,), 1e20, jnp.float32)   # K2 ~ k^2 h y -> inf
        state = merson_init(y0, 0.0, 1.0)
        params0 = MersonParams(delta=1e-3, h_min=0.0, max_steps=50)
        st0, status0 = jax.jit(
            lambda s: merson_solve(f, s, 1.0, params0))(state)
        assert int(status0) == -7  # MAX_STEPS: it would spin forever
        assert float(jnp.abs(st0.h)) == 0.0
        assert int(st0.steps) == 0
        # with the backoff, h never touches 0
        params1 = MersonParams(delta=1e-3, h_min=0.0, max_steps=50,
                               handle_nan=True)
        st1, _ = jax.jit(
            lambda s: merson_solve(f, s, 1.0, params1))(state)
        assert float(jnp.abs(st1.h)) > 0.0


class TestAcceptGrowthMin:
    """The noise-floor escape (MersonParams.accept_growth_min).

    The reference growth rule 0.8*(delta/eps)^0.2 has its fixed point at
    eps = 0.8^5 * delta = 0.328 delta: an h-independent estimator noise
    floor at that value pins h forever (the f32 stage-state rounding
    produces exactly such a floor on developed GradP fields).  A synthetic
    h-independent floor reproduces the pinning; the growth floor must
    escape it without breaking accuracy.
    """

    @staticmethod
    def _noisy_rhs(floor, n=128):
        # y' = 1 plus tiny fast decorrelated oscillations: the max-norm
        # Merson error combination over the n components sees a STABLE
        # h-independent O(2*floor) contribution (a max over many random
        # phases concentrates at the envelope — like the max over grid
        # cells of f32 rounding noise), while the solution stays
        # y ~ t + O(floor/omega)
        rng = np.random.RandomState(0)
        om = jnp.asarray(1e7 * (1.0 + rng.rand(n)))
        ph = jnp.asarray(2 * np.pi * rng.rand(n))
        return lambda t, y: 1.0 + floor * jnp.sin(om * t + ph)

    def test_pinning_without_floor(self):
        delta = 1e-3
        f = self._noisy_rhs(0.20e-3)  # envelope ~0.4e-3 > 0.328*delta
        st, status = solve_jax(f, 0.0, np.zeros(128), 1.0, 1e-4,
                               delta=delta, max_steps=200_000)
        assert status == 0
        pinned_steps = int(st.steps_total)  # measured: ~700 (h pins ~6e-3)

        st2, status2 = solve_jax(f, 0.0, np.zeros(128), 1.0, 1e-4,
                                 delta=delta, max_steps=200_000,
                                 accept_growth_min=1.05)
        assert status2 == 0
        # the escape must beat the pinned run decisively (measured ~5.5x)
        # and still land on the right answer
        assert int(st2.steps_total) * 4 < pinned_steps
        assert float(st2.y[0]) == pytest.approx(1.0, abs=1e-4)
        assert float(st.y[0]) == pytest.approx(1.0, abs=1e-4)

    def test_no_growth_on_forced_accepts(self):
        # an h_min-forced accept (|h| < h_min with eps >= delta) must NOT
        # be floored up: the reference shrinks h monotonically there and
        # growing it would oscillate h around h_min.  A constant huge
        # error keeps every step at eps >> delta; starting below h_min
        # every step is a forced accept with fac = 0.8*(delta/eps)^0.2
        # < 1 — so with the floor active h must still shrink every step.
        big = 1e6
        rng = np.random.RandomState(1)
        om = jnp.asarray(1e9 * (1.0 + rng.rand(16)))
        f = lambda t, y: big * jnp.sin(om * t)
        params = MersonParams(delta=1e-3, h_min=1e-2, max_steps=50,
                              accept_growth_min=1.05)
        state = merson_init(jnp.zeros(16, jnp.float64), 0.0, 1e-3)
        st, status = jax.jit(
            lambda s: merson_solve(f, s, 1e9, params))(state)
        # every attempt was a forced accept; h only ever shrank
        assert int(st.steps) == int(st.steps_total) == 50
        assert float(jnp.abs(st.h)) < 1e-3

    def test_no_effect_when_error_dominates(self):
        # smooth stiff-ish problem, estimator is true-error dominated:
        # the floor may add a few rejects but must not change the
        # solution and must stay within ~1.35x of the reference attempts
        f = lambda t, y: -8.0 * y
        st, _ = solve_jax(f, 0.0, [1.0], 1.0, 1e-3, delta=1e-7)
        st2, _ = solve_jax(f, 0.0, [1.0], 1.0, 1e-3, delta=1e-7,
                           accept_growth_min=1.05)
        # different (still delta-controlled) step sequence: same answer
        # to well within the tolerance's global-error scale
        assert float(st2.y[0]) == pytest.approx(float(st.y[0]), rel=1e-4)
        assert int(st2.steps_total) <= int(st.steps_total) * 1.35


class TestNanMax:
    """The error max keeps a NaN from any shard (a GPU max all-reduce
    drops NaN operands, which would let a poisoned step be accepted)."""

    @pytest.mark.parametrize("where", [None, 0, 37, 63])
    def test_nan_max_sharded(self, where):
        from porousfreezethaw.parallel.sharding import make_mesh
        from porousfreezethaw.solvers.merson import nan_max
        from jax.sharding import NamedSharding, PartitionSpec as P
        x = np.linspace(0.5, 2.0, 64)
        if where is not None:
            x[where] = np.nan
        mesh = make_mesh("z8")
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("z")))
        got = float(jax.jit(nan_max)(xs))
        if where is None:
            assert got == 2.0
        else:
            assert np.isnan(got)
