"""Fixed-trajectory HMC kernel (companion to NUTS).

Not present in the reference (Stan's NUTS is its only sampler), but exposed
because a fixed-length kernel suits an accelerator (static trajectory
length → no data-dependent while_loop) and is often faster per effective
sample for well-conditioned weighted posteriors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .integrators import (IntegratorState, kinetic, leapfrog,
                          sample_momentum)


class HMCInfo(NamedTuple):
    accept_prob: jax.Array
    accepted: jax.Array


def hmc_kernel(value_and_grad_fn: Callable, key, state: IntegratorState,
               step_size, inv_mass, num_steps: int = 32,
               jitter_steps: bool = True, inv_mass_chol=None):
    """One Metropolis-corrected HMC transition with ``num_steps`` leapfrogs.

    ``jitter_steps`` draws the trajectory length uniformly in
    [1, num_steps] each transition — the standard guard against periodic
    trajectories resonating with the target's frequencies.
    ``inv_mass_chol``: optional precomputed ``mass_chol(inv_mass)``.
    """
    km, ka, kj = jax.random.split(key, 3)
    r0 = sample_momentum(km, inv_mass, state.z.shape, state.z.dtype,
                         chol=inv_mass_chol)
    s0 = IntegratorState(state.z, r0, state.logp, state.grad)
    joint0 = s0.logp - kinetic(r0, inv_mass)

    if jitter_steps:
        n_steps = jax.random.randint(kj, (), 1, num_steps + 1)
    else:
        n_steps = num_steps

    def body(_, s):
        return leapfrog(value_and_grad_fn, s, step_size, inv_mass)

    s1 = jax.lax.fori_loop(0, n_steps, body, s0)
    joint1 = s1.logp - kinetic(s1.r, inv_mass)
    log_accept = jnp.where(jnp.isnan(joint1), -jnp.inf, joint1 - joint0)
    accept_prob = jnp.minimum(1.0, jnp.exp(jnp.minimum(log_accept, 0.0)))
    accepted = jax.random.uniform(ka) < accept_prob
    new = jax.tree.map(lambda a, b: jnp.where(accepted, a, b), s1, s0)
    return IntegratorState(new.z, jnp.zeros_like(r0), new.logp, new.grad), \
        HMCInfo(accept_prob, accepted)
