"""Weighted-likelihood posteriors and the user-facing MCMC entry point.

The reference achieves weighted-likelihood MCMC by hand-editing
Stan-generated C++ to scale each datum's log-likelihood contribution
(reference examples/common/mcmc.py:9-30 and
examples/common/stan_cache/weighted_*.cpp — the repo's only native code).
Here the weighted log-joint is just a jittable function
``sum_i w_i ll_i(theta) + log pi(theta)`` and any model module with
``log_joint`` works unmodified.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

from .sample import MCMCResult, run_nuts


def weighted_logdensity(model, z, wts, ref: jax.Array | None = None) -> Callable:
    """Build theta -> log p(theta) + sum_i w_i ll(z_i, theta) (+ const).

    ``model`` is any module/namespace exposing ``log_joint(z, th, wts)``
    batched over rows of th (e.g. models.logistic, models.poisson).

    With ``ref`` (and a model exposing ``log_likelihood``/``log_prior``),
    the density is evaluated RELATIVE to the reference point:
    ``sum_i w_i (ll_i(theta) - ll_i(ref)) + log pi(theta)`` — the same
    function up to a constant, but numerically transformative for
    concentrated weighted posteriors: the absolute weighted sum reaches
    ~|1e5| where f32 accumulation noise is ~0.05 (enough to poison NUTS
    energy differences and collapse step-size adaptation — observed on
    airportdelays/biketrips), while per-datum DIFFERENCES near ref are
    O(0.1) and their weighted sum stays small and f32-exact.
    """
    z = jnp.asarray(z)
    wts = jnp.asarray(wts)

    if ref is not None and hasattr(model, "log_likelihood_diff") \
            and hasattr(model, "log_prior"):
        # stable per-datum differences (see models.*.log_likelihood_diff):
        # each term carries error relative to its own SMALL magnitude, so
        # the weighted sum is f32-clean even where |ll_i| ~ 1e4 would make
        # naive subtraction amplify rounding into O(1) Hamiltonian noise
        ref_arr = jnp.asarray(ref)

        def logdensity(theta):
            dll = model.log_likelihood_diff(z, theta[None, :], ref_arr)[:, 0]
            return jnp.dot(wts, dll) + model.log_prior(theta[None, :])[0]

        return logdensity

    if ref is not None and hasattr(model, "log_likelihood") and hasattr(model, "log_prior"):
        ll_ref = model.log_likelihood(z, jnp.asarray(ref)[None, :])[:, 0]

        def logdensity(theta):
            ll = model.log_likelihood(z, theta[None, :])[:, 0]
            return jnp.dot(wts, ll - ll_ref) + model.log_prior(theta[None, :])[0]

        return logdensity

    def logdensity(theta):
        return model.log_joint(z, theta[None, :], wts)[0]

    return logdensity


def fit_laplace(model, z, wts, d: int):
    """Laplace approximation of the weighted posterior, or None if the model
    lacks gradient/Hessian functions."""
    grad_fn = getattr(model, "grad_th_log_joint", None)
    hess_fn = getattr(model, "hess_th_log_joint", None)
    if grad_fn is None or hess_fn is None:
        return None
    from ..models.laplace import laplace_approx
    return laplace_approx(jnp.asarray(z), jnp.asarray(wts), jnp.zeros(d),
                          grad_fn=grad_fn, hess_fn=hess_fn)


def laplace_init(model, z, wts, num_chains: int, key, d: int):
    """Overdispersed chain initializations from the Laplace approximation.

    Concentrated weighted posteriors (total weight ~N) sit tens of
    posterior-sds from the zero vector; a chain that has not finished that
    transit when the first adaptation window closes locks in a collapsed
    mass matrix and freezes.  Initializing from the Laplace fit (available
    for every model exposing grad/hess of the log-joint) starts every chain
    in the typical set AND gives properly overdispersed inits for split
    R-hat.  Falls back to zeros when the model lacks Hessians.
    """
    lap = fit_laplace(model, z, wts, d)
    if lap is None:
        return jnp.zeros((num_chains, d), jnp.asarray(z).dtype)
    from ..models.laplace import sample_laplace
    return sample_laplace(key, lap, num_chains)


def _shard_chain_inits(init_params, mesh):
    """Lay chain inits over the mesh's chain axis so run_nuts' vmapped batch
    dimension is device-sharded (the same placement as
    parallel.mcmc.run_nuts_sharded): each device runs its resident chains
    and pooled-adaptation means become XLA collectives over the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec

    from ..parallel.mesh import CHAIN_AXIS
    axis = CHAIN_AXIS if CHAIN_AXIS in mesh.axis_names else mesh.axis_names[0]
    return jax.device_put(init_params, NamedSharding(mesh, PartitionSpec(axis, None)))


def run(model, z, wts, n_samples: int, key, d: int | None = None,
        num_chains: int = 1, max_depth: int = 15, target_accept: float = 0.9,
        init: jax.Array | None = None, pooled_adaptation: bool = False,
        num_warmup: int | None = None, precondition: bool = True,
        f64_logdensity: bool = False, dense_mass: bool = False,
        mesh=None):
    """Weighted-posterior NUTS with the reference driver's conventions.

    Mirrors ``mcmc.run(...) -> (samples, t_sample)`` (reference
    examples/common/mcmc.py:58-68): ``n_samples`` PER-CHAIN kept draws after
    ``num_warmup`` warmup steps (default: ``n_samples``, the reference's
    iter=2*N-with-half-burn-in convention), ``target_accept`` defaults
    to Stan's adapt_delta=0.9, and ``max_depth`` defaults to the
    reference's max_treedepth=15 (mcmc.py:58).  Depth only bounds the
    doubling loop — trees still stop at the first u-turn/divergence — so
    on well-conditioned (preconditioned) posteriors the deeper cap costs
    nothing beyond the (max_depth, d) checkpoint buffers; it matters
    exactly when adaptation lands on a small step size and the reference
    convention would keep integrating.  When splitting a total draw budget across
    chains, pass ``num_warmup`` explicitly — warmup/adaptation length must
    NOT shrink with the chain count (each chain adapts independently of how
    many siblings it has; an 8-way split of a 2000-draw budget would
    otherwise leave 250-step warmups that cannot adapt hard posteriors).

    ``precondition=True`` (when the model exposes grad/hess of the
    log-joint) samples the EXACT reparameterization theta = mu + USig @ u
    around the Laplace fit, so NUTS runs on a ~N(0, I) geometry: weighted
    coreset posteriors concentrate their curvature by factors of the total
    weight (~N/M per point), far beyond what Stan's diagonal mass
    adaptation can equalize — the affine change of variables (constant
    Jacobian, no distribution change) removes the conditioning problem at
    the source.  Diagnostics in the returned MCMCResult are transformed
    back to theta space; ``step_size``/``inv_mass`` describe u space.
    Pass ``init`` (theta-space chain inits) to disable preconditioning.

    ``dense_mass=True`` adapts a full covariance metric (Stan's ``dense_e``)
    — the principled control when the (possibly preconditioned) posterior
    stays correlated beyond what a diagonal can fix (e.g. airportdelays'
    d=16 extreme weight concentration).

    ``mesh``: optional ``jax.sharding.Mesh`` — chain inits are sharded over
    its chain axis so chains run device-parallel (``num_chains`` must be a
    multiple of the axis size); the sampled distribution is unchanged.
    Returns (samples (num_chains*n_samples, d), wall_seconds, MCMCResult).
    """
    z = jnp.asarray(z)
    if d is None:
        d = z.shape[1]
    # NUTS energy differences need full-f32 logits: reduced-precision matmul
    # inputs (bf16 on some accelerators, TF32 by default on GPUs), scaled by
    # weight*count, poison the Hamiltonian and collapse step-size adaptation
    # (chains froze on airportdelays/biketrips with adapted steps ~1e-3
    # while the same arithmetic on f32 CPU adapted to ~0.55).  The sampler's matmuls are
    # (n, d) logits — negligible next to the coreset-build hot path.
    with jax.default_matmul_precision("highest"):
        lap = fit_laplace(model, z, wts, d) if (precondition and init is None) else None
        if lap is not None:
            mu, A = lap.mu, lap.USig                # Sig = A @ A.T
            if f64_logdensity:
                # f64 ISLAND for the log-density only: extreme weighted
                # posteriors (weight*count ~ 1e6) amplify f32 rounding of
                # the large ll intermediates into O(1) Hamiltonian noise.
                # The integrator, adaptation, and states all stay f32; only
                # the density (and its grad path) computes in f64 and the
                # small RELATIVE value is rounded back to f32.  Default OFF,
                # and since the stable pairwise-difference likelihood
                # (models.*.log_likelihood_diff, which converged every
                # reference dataset incl. biketrips/airportdelays _large at
                # f32) removed the cancellation at the source, this island
                # is a diagnostic tool rather than a convergence
                # requirement.
                x64_ctx = jax.enable_x64()
            else:
                import contextlib
                x64_ctx = contextlib.nullcontext()

            with x64_ctx:
                # casts MUST happen inside the context: outside it jax
                # silently truncates requested float64 back to float32
                if f64_logdensity:
                    zl = z.astype(jnp.float64)
                    wl = jnp.asarray(wts).astype(jnp.float64)
                    mul, Al = mu.astype(jnp.float64), A.astype(jnp.float64)
                else:
                    zl, wl, mul, Al = z, wts, mu, A
                # built inside the context so the f64 reference lls are real
                logdensity_rel = weighted_logdensity(model, zl, wl, ref=mul)

                def logdensity_u(u):
                    th = mul + Al @ u.astype(zl.dtype)
                    return logdensity_rel(th).astype(jnp.float32)

                key, k_init = jax.random.split(key)
                init_u = jax.random.normal(k_init, (num_chains, d), jnp.float32)
                if mesh is not None:
                    init_u = _shard_chain_inits(init_u, mesh)
                t0 = time.perf_counter()
                res: MCMCResult = run_nuts(logdensity_u, init_u, key,
                                           num_warmup=num_warmup or n_samples,
                                           num_samples=n_samples,
                                           max_depth=max_depth,
                                           target_accept=target_accept,
                                           pooled_adaptation=pooled_adaptation,
                                           dense_mass=dense_mass)
                jax.block_until_ready(res.samples)
                t = time.perf_counter() - t0
            theta = res.samples @ A.T + mu          # (chains, draws, d)
            res = res._replace(samples=theta)
            return theta.reshape(-1, d), t, res
        logdensity = weighted_logdensity(model, z, wts)
        if init is None:
            key, k_init = jax.random.split(key)
            init = laplace_init(model, z, wts, num_chains, k_init, d)
        if mesh is not None:
            init = _shard_chain_inits(init, mesh)
        t0 = time.perf_counter()
        res: MCMCResult = run_nuts(logdensity, init, key,
                                   num_warmup=num_warmup or n_samples,
                                   num_samples=n_samples, max_depth=max_depth,
                                   target_accept=target_accept,
                                   pooled_adaptation=pooled_adaptation,
                                   dense_mass=dense_mass)
        jax.block_until_ready(res.samples)
        t = time.perf_counter() - t0
        samples = res.samples.reshape(-1, d)
        return samples, t, res
