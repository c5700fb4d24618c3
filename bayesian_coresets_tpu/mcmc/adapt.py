"""Warmup adaptation: dual-averaging step size + windowed mass matrix.

Stan-style adaptation schedule (the reference relies on Stan's
``adapt_delta=0.9`` control, examples/common/mcmc.py:58-65): an initial
fast window for step size only, doubling slow windows accumulating Welford
statistics for the mass matrix (diagonal variances by default, the full
scatter matrix for the dense metric — Stan's diag_e/dense_e), and a
terminal fast window.  The schedule is precomputed host-side as boolean
masks so the whole warmup runs in one ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DualAveragingState(NamedTuple):
    log_step: jax.Array
    log_step_avg: jax.Array
    h_bar: jax.Array
    mu: jax.Array
    count: jax.Array


_LOG10 = 2.302585092994046


def da_init(step_size):
    log_step = jnp.log(step_size)
    # the running average starts AT the current step (not exp(0)=1), so a
    # zero-length window after a boundary reset keeps a sane step size.
    # Literals stay weakly-typed / dtype-pinned so an enclosing x64 context
    # (mcmc.run's f64 log-density island) cannot promote the carried state.
    zero = jnp.zeros((), log_step.dtype)
    return DualAveragingState(log_step, log_step, zero,
                              _LOG10 + log_step, zero)


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_step = state.mu - jnp.sqrt(count) / gamma * h_bar
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, state.mu, count)


class WelfordState(NamedTuple):
    count: jax.Array
    mean: jax.Array
    m2: jax.Array     # (d,) running variance sum, or (d, d) scatter matrix


def welford_init(d, dtype=jnp.float32, dense: bool = False):
    """``dense=True`` accumulates the full (d, d) scatter matrix for the
    dense metric (Stan's ``dense_e``); default is the diagonal estimator."""
    m2 = jnp.zeros((d, d) if dense else d, dtype)
    return WelfordState(jnp.zeros((), dtype), jnp.zeros(d, dtype), m2)


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    if state.m2.ndim == 2:
        m2 = state.m2 + jnp.outer(delta, x - mean)
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_update_batch(state: WelfordState, xs) -> WelfordState:
    """Merge a batch of samples xs (C, d) in one step (Chan et al. parallel
    update) — used by pooled cross-chain adaptation where every warmup step
    contributes one position per chain."""
    import jax.numpy as _jnp

    c = xs.shape[0]
    batch_mean = _jnp.mean(xs, axis=0)
    centered = xs - batch_mean
    count = state.count + c
    delta = batch_mean - state.mean
    mean = state.mean + delta * (c / count)
    if state.m2.ndim == 2:
        # full-f32 scatter: this matrix becomes the inverse mass, and
        # reduced-precision matmul inputs (TF32 is the GPU default) would
        # bake that rounding into the metric NUTS integrates under (see
        # integrators.mass_mul)
        batch_m2 = _jnp.matmul(centered.T, centered,
                               precision=jax.lax.Precision.HIGHEST)
        m2 = (state.m2 + batch_m2
              + _jnp.outer(delta, delta) * (state.count * c / count))
    else:
        batch_m2 = _jnp.sum(centered**2, axis=0)
        m2 = state.m2 + batch_m2 + delta**2 * (state.count * c / count)
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState):
    """Regularized variance/covariance estimate (Stan's shrinkage toward
    unit): diag m2 -> (d,) variances; dense m2 -> (d, d) covariance with the
    identity-scaled ridge keeping the estimate positive definite through the
    early short windows."""
    n = jnp.maximum(state.count, 1.0)
    var = state.m2 / jnp.maximum(n - 1.0, 1.0)
    shrink = n / (n + 5.0)
    ridge = 1e-3 * (5.0 / (n + 5.0))
    if state.m2.ndim == 2:
        cov = shrink * var + ridge * jnp.eye(state.m2.shape[0], dtype=state.m2.dtype)
        # the accumulated outer(delta, x - mean) is symmetric only in exact
        # arithmetic; Cholesky reads one triangle but mass_mul uses the full
        # matrix, so symmetrize to keep metric ops and sampled momenta in
        # exact agreement
        return 0.5 * (cov + cov.T)
    return shrink * var + ridge


def build_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                   base_window: int = 25):
    """Boolean masks over warmup iterations: (in_slow_window, window_end).

    Mirrors Stan's windowed adaptation; degenerates gracefully for short
    warmups (mass adaptation disabled below ~20 iterations).
    """
    in_slow = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    if num_warmup < init_buffer + term_buffer + base_window:
        # too short for windows: step-size-only adaptation
        return in_slow, window_end
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = min(start + size, num_warmup - term_buffer)
        # if the next window would not fit, extend this one to the boundary
        if end + size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_slow[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_slow, window_end


def build_segments(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                   base_window: int = 25):
    """Static warmup segmentation: tuple of (length, slow, boundary).

    ``slow``: accumulate Welford mass statistics during the segment;
    ``boundary``: at segment end, swap in the new mass matrix, RE-SEARCH a
    reasonable step size under it, and restart dual averaging (Stan's window
    semantics — restarting around the old step after the metric changes
    leaves it in the wrong units, and chains that land orders of magnitude
    off cannot recover within the next window).
    """
    in_slow, window_end = build_schedule(num_warmup, init_buffer, term_buffer,
                                         base_window)
    segments = []
    start = 0
    for i in range(num_warmup):
        boundary = bool(window_end[i])
        last = i == num_warmup - 1
        change = (not last) and (bool(in_slow[i + 1]) != bool(in_slow[i]))
        if boundary or last or change:
            segments.append((i - start + 1, bool(in_slow[i]), boundary))
            start = i + 1
    return tuple(s for s in segments if s[0] > 0)


def find_reasonable_step_size(value_and_grad_fn, z, logp, grad, inv_mass,
                              key, init_step=1.0, target=0.8, chol=None):
    """Double/halve the step until the one-step acceptance crosses 0.5
    (Hoffman & Gelman Algorithm 4), as a bounded jittable loop.

    ``chol``: optional precomputed ``mass_chol(inv_mass)``."""
    from .integrators import IntegratorState, kinetic, leapfrog, sample_momentum

    r0 = sample_momentum(key, inv_mass, z.shape, z.dtype, chol=chol)
    s0 = IntegratorState(z, r0, logp, grad)
    joint0 = logp - kinetic(r0, inv_mass)

    def accept_logp(step):
        s1 = leapfrog(value_and_grad_fn, s0, step, inv_mass)
        out = s1.logp - kinetic(s1.r, inv_mass) - joint0
        return jnp.where(jnp.isnan(out), -jnp.inf, out)

    init_dir = jnp.where(accept_logp(init_step) > jnp.log(0.5), 1.0, -1.0)

    def cond(carry):
        step, i = carry
        crossed = (accept_logp(step) > jnp.log(0.5)) != (init_dir > 0)
        return (~crossed) & (i < 60)

    def body(carry):
        step, i = carry
        return step * jnp.where(init_dir > 0, 2.0, 0.5), i + 1

    step, iters = jax.lax.while_loop(cond, body,
                                     (jnp.asarray(init_step, z.dtype), 0))
    # a search that never crosses 0.5 within 60 doublings/halvings is
    # pathological (e.g. a non-finite cached gradient makes every accept
    # -inf); returning the runaway 2^±60 step would freeze or explode the
    # sampler — keep the caller's step instead
    return jnp.where(iters < 60, step, jnp.asarray(init_step, z.dtype))
