"""No-U-Turn Sampler with bounded-depth iterative tree building.

Replaces the reference's Stan C++ NUTS (invoked through pystan with
hand-edited weighted-likelihood C++, reference examples/common/mcmc.py:9-68
and stan_cache/*.cpp).  Weighted likelihoods need no codegen surgery here:
the weights enter the jittable log-density as ``sum_i w_i * ll_i(theta)``
(see mcmc/weighted.py), and the sampler is model-agnostic.

Design notes (XLA):
- Recursion is replaced by the standard iterative doubling scheme with a
  binary-counter checkpoint stack (slot = popcount(leaf index) for even
  leaves; odd leaves check U-turns against a contiguous slot range derived
  from their trailing one-bits).  All shapes are static: the stack has
  ``max_depth`` slots, the outer loop runs at most ``max_depth`` doublings,
  and each doubling's 2^j leapfrog steps run in a ``lax.while_loop``.
- Proposals use progressive multinomial sampling within a subtree and
  biased progressive sampling across doublings (Stan's scheme).
- Divergence threshold 1000 (Stan default); diagonal OR dense mass matrix
  (``inv_mass`` rank dispatches at trace time — see integrators.py).

The reference's ``control={'max_treedepth': 15}`` (mcmc.py:58-65) maps to
``max_depth``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .integrators import (IntegratorState, kinetic, leapfrog, mass_mul,
                          sample_momentum)

DIVERGENCE_THRESHOLD = 1000.0


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array   # mean leapfrog acceptance statistic
    diverging: jax.Array     # bool
    depth: jax.Array         # tree depth reached
    num_steps: jax.Array     # leapfrog steps taken


def _popcount(n):
    # int32 popcount via bit tricks (no jnp.bitwise_count dependency)
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    return (n * 0x01010101) >> 24


def _trailing_ones(n):
    # number of contiguous low-order 1 bits of n
    return _popcount(n & ~(n + 1))


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass):
    """Original NUTS U-turn criterion with mass-matrix metric (diag or dense)."""
    dz = z_plus - z_minus
    return (jnp.dot(dz, mass_mul(inv_mass, r_minus)) < 0) | \
           (jnp.dot(dz, mass_mul(inv_mass, r_plus)) < 0)


class _SubtreeCarry(NamedTuple):
    s: IntegratorState            # current (outermost) point
    ckpt_z: jax.Array             # (max_depth, d) even-leaf positions
    ckpt_r: jax.Array             # (max_depth, d) even-leaf momenta
    prop: IntegratorState         # subtree proposal
    logw: jax.Array               # logsumexp of leaf weights in subtree
    sum_accept: jax.Array
    turning: jax.Array
    diverging: jax.Array
    i: jax.Array                  # leaf counter within subtree
    key: jax.Array


def _build_subtree(value_and_grad_fn, start: IntegratorState, num_steps, step,
                   inv_mass, joint0, max_depth, key):
    """Simulate ``num_steps`` leapfrog steps from ``start``; returns the
    subtree proposal, accumulated weight, endpoint, and termination flags."""
    d = start.z.shape[0]

    def cond(c: _SubtreeCarry):
        return (c.i < num_steps) & ~c.turning & ~c.diverging

    def body(c: _SubtreeCarry) -> _SubtreeCarry:
        s = leapfrog(value_and_grad_fn, c.s, step, inv_mass)
        logw_leaf = s.logp - kinetic(s.r, inv_mass) - joint0
        # a leaf with non-finite position/GRADIENT must never be proposed
        # even when its logp is finite: caching an inf gradient poisons
        # every later leapfrog and step-size search from that chain
        # (observed on airportdelays: one poisoned chain collapsed the
        # pooled step size to 1e-27 and froze all chains)
        finite = (jnp.isfinite(s.logp) & jnp.all(jnp.isfinite(s.grad))
                  & jnp.all(jnp.isfinite(s.z)))
        logw_leaf = jnp.where(jnp.isnan(logw_leaf) | ~finite, -jnp.inf, logw_leaf)
        diverging = logw_leaf < -DIVERGENCE_THRESHOLD
        accept = jnp.minimum(1.0, jnp.exp(jnp.minimum(logw_leaf, 0.0)))

        # progressive multinomial proposal within the subtree
        key, ku = jax.random.split(c.key)
        new_logw = jnp.logaddexp(c.logw, logw_leaf)
        p_take = jnp.exp(logw_leaf - new_logw)
        take = jax.random.uniform(ku) < p_take
        prop = jax.tree.map(lambda a, b: jnp.where(take, a, b), s, c.prop)

        # binary-counter checkpointing + U-turn checks
        i = c.i
        is_even = (i % 2) == 0
        slot = jnp.clip(_popcount(i), 0, max_depth - 1)
        ckpt_z = jnp.where(is_even, c.ckpt_z.at[slot].set(s.z), c.ckpt_z)
        ckpt_r = jnp.where(is_even, c.ckpt_r.at[slot].set(s.r), c.ckpt_r)

        idx_max = _popcount(i) - 1
        idx_min = idx_max - _trailing_ones(i) + 1

        # vectorized U-turn checks against all checkpoint slots at once
        # (a fori_loop here puts ~max_depth sequential gathers+dots on the
        # per-leapfrog critical path — NUTS is latency-bound on an
        # accelerator, so the slot loop must be two matvecs + a masked any())
        ks = jnp.arange(max_depth)
        in_range = (ks >= idx_min) & (ks <= idx_max) & ~is_even
        dz = s.z[None, :] - ckpt_z                        # (max_depth, d)
        t_minus = jnp.sum(dz * mass_mul(inv_mass, ckpt_r), axis=1) < 0
        t_plus = (dz @ mass_mul(inv_mass, s.r)) < 0
        turning = c.turning | jnp.any(in_range & (t_minus | t_plus))

        return _SubtreeCarry(s, ckpt_z, ckpt_r, prop, new_logw,
                             c.sum_accept + accept, turning, diverging, i + 1, key)

    init = _SubtreeCarry(
        s=start,
        ckpt_z=jnp.zeros((max_depth, d), start.z.dtype),
        ckpt_r=jnp.zeros((max_depth, d), start.z.dtype),
        prop=start,
        logw=jnp.asarray(-jnp.inf, jnp.float32),
        sum_accept=jnp.zeros((), jnp.float32),
        turning=jnp.array(False),
        diverging=jnp.array(False),
        i=jnp.int32(0),
        key=key,
    )
    out = jax.lax.while_loop(cond, body, init)
    return out


class _TreeCarry(NamedTuple):
    left: IntegratorState
    right: IntegratorState
    prop: IntegratorState
    logw: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_accept: jax.Array
    num_steps: jax.Array
    key: jax.Array


def nuts_kernel(value_and_grad_fn: Callable, key, state: IntegratorState,
                step_size, inv_mass, max_depth: int = 10, inv_mass_chol=None):
    """One NUTS transition.  ``state.r`` is ignored (fresh momentum drawn).

    ``inv_mass_chol``: optional precomputed ``mass_chol(inv_mass)`` so dense
    metrics are factored once per adaptation segment, not per transition."""
    key, km = jax.random.split(key)
    r0 = sample_momentum(km, inv_mass, state.z.shape, state.z.dtype,
                         chol=inv_mass_chol)
    s0 = IntegratorState(state.z, r0, state.logp, state.grad)
    joint0 = s0.logp - kinetic(r0, inv_mass)

    def cond(c: _TreeCarry):
        return (c.depth < max_depth) & ~c.turning & ~c.diverging

    def body(c: _TreeCarry) -> _TreeCarry:
        key, kd, ks, kb = jax.random.split(c.key, 4)
        go_right = jax.random.bernoulli(kd)
        start = jax.tree.map(lambda a, b: jnp.where(go_right, a, b), c.right, c.left)
        signed_step = jnp.where(go_right, step_size, -step_size)
        num_steps = jnp.int32(1) << c.depth

        sub = _build_subtree(value_and_grad_fn, start, num_steps, signed_step,
                             inv_mass, joint0, max_depth, ks)

        ok = ~sub.turning & ~sub.diverging
        # biased progressive sampling across doublings (Stan)
        p_take = jnp.minimum(1.0, jnp.exp(sub.logw - c.logw))
        take = ok & (jax.random.uniform(kb) < p_take)
        prop = jax.tree.map(lambda a, b: jnp.where(take, a, b), sub.prop, c.prop)
        logw = jnp.where(ok, jnp.logaddexp(c.logw, sub.logw), c.logw)

        left = jax.tree.map(lambda a, b: jnp.where(go_right, b, a), sub.s, c.left)
        right = jax.tree.map(lambda a, b: jnp.where(go_right, a, b), sub.s, c.right)
        whole_turn = ok & _is_turning(left.z, left.r, right.z, right.r, inv_mass)

        return _TreeCarry(
            left=left, right=right, prop=prop, logw=logw,
            depth=c.depth + 1,
            turning=sub.turning | whole_turn,
            diverging=sub.diverging,
            sum_accept=c.sum_accept + sub.sum_accept,
            num_steps=c.num_steps + sub.i,
            key=key,
        )

    init = _TreeCarry(
        left=s0, right=s0, prop=s0, logw=jnp.zeros((), jnp.float32),
        depth=jnp.int32(0), turning=jnp.array(False), diverging=jnp.array(False),
        sum_accept=jnp.zeros((), jnp.float32), num_steps=jnp.int32(0), key=key,
    )
    out = jax.lax.while_loop(cond, body, init)

    new_state = IntegratorState(out.prop.z, jnp.zeros_like(r0), out.prop.logp,
                                out.prop.grad)
    n = jnp.maximum(out.num_steps, 1)
    info = NUTSInfo(out.sum_accept / n, out.diverging, out.depth, out.num_steps)
    return new_state, info
