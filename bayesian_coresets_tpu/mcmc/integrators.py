"""Leapfrog integrator + metric operations for HMC/NUTS.

The mass-matrix metric is a single array ``inv_mass`` whose rank selects
the geometry at TRACE time (both paths compile to static code):

- ``(d,)``  — diagonal metric, ``inv_mass`` = estimated posterior variances
  (Stan's ``diag_e``, the reference's implicit default via pystan).
- ``(d, d)`` — dense metric, ``inv_mass`` = regularized posterior
  covariance estimate Sigma = M^{-1} (Stan's ``dense_e``).  Momentum is
  drawn as r = L^{-T} u with Sigma = L L^T, so cov(r) = Sigma^{-1} = M.

Dense mode targets strongly correlated posteriors where no diagonal
rescaling helps (e.g. the airportdelays d=16 coreset posteriors); its
per-transition cost is one (d, d) Cholesky + O(d^2) matvecs per leapfrog —
negligible next to the log-density gradient for the small-d weighted
posteriors this package samples.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class IntegratorState(NamedTuple):
    z: jax.Array      # position (d,)
    r: jax.Array      # momentum (d,)
    logp: jax.Array   # log-density at z
    grad: jax.Array   # d logp / dz


def mass_mul(inv_mass, r):
    """M^{-1} r (the metric velocity).  ``r`` may be (d,) or batched (K, d);
    the dense inverse mass is symmetric so ``r @ inv_mass`` covers both.

    The dense matmul pins full-f32 precision: GPU matmuls default to TF32
    inputs, and NUTS energy differences are exactly the quantity this repo
    documents (weighted.py) as poisoned by reduced precision — a direct
    run_nuts(dense_mass=True) must be safe without the caller wrapping it
    in default_matmul_precision('highest').  At d<=16 the cost is nil."""
    if inv_mass.ndim == 1:
        return r * inv_mass
    return jnp.matmul(r, inv_mass, precision=jax.lax.Precision.HIGHEST)


def mass_chol(inv_mass):
    """Factor of the inverse mass used by ``sample_momentum``: sqrt for the
    diagonal metric, the lower-Cholesky L (Sigma = L L^T) for dense.  The
    metric is constant within every warmup segment and the whole sampling
    phase, so callers factor ONCE per segment and pass the result down
    instead of re-factoring every transition."""
    if inv_mass.ndim == 1:
        return jnp.sqrt(inv_mass)
    return jnp.linalg.cholesky(inv_mass)


def sample_momentum(key, inv_mass, shape, dtype, chol=None):
    """Draw r ~ N(0, M) for the given metric (M = inv_mass^{-1}).

    ``chol``: optional precomputed ``mass_chol(inv_mass)`` (avoids a
    per-transition Cholesky in dense mode)."""
    u = jax.random.normal(key, shape, dtype)
    if chol is None:
        chol = mass_chol(inv_mass)
    if inv_mass.ndim == 1:
        return u / chol
    # Sigma = L L^T  =>  M = L^{-T} L^{-1};  r = L^{-T} u has cov M
    return jax.scipy.linalg.solve_triangular(chol.T, u, lower=False)


def leapfrog(value_and_grad_fn: Callable, state: IntegratorState, step_size,
             inv_mass) -> IntegratorState:
    """One leapfrog step; ``step_size`` may be negative (backward in time)."""
    r = state.r + 0.5 * step_size * state.grad
    z = state.z + step_size * mass_mul(inv_mass, r)
    logp, grad = value_and_grad_fn(z)
    r = r + 0.5 * step_size * grad
    return IntegratorState(z, r, logp, grad)


def kinetic(r, inv_mass):
    return 0.5 * jnp.sum(r * mass_mul(inv_mass, r), axis=-1)
