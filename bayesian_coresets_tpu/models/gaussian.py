"""Conjugate multivariate-Gaussian model.

Covers the reference's ``examples/common/model_gaussian.py:4-30``: batched
log-likelihood, data-gradient, Gaussian-vs-Gaussian KL, and the closed-form
weighted posterior.  All linear algebra is batched (Cholesky + triangular
solves) and jittable; the (n, S) likelihood matrix comes from one
``x @ Siginv @ th.T`` matmul chain.

Model: x_i ~ N(theta, Sig), theta ~ N(mu0, Sig0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_LOG2PI = 1.8378770664093453


def log_likelihood(x: jax.Array, th: jax.Array, Siginv: jax.Array, logdetSig) -> jax.Array:
    """Batched Gaussian log-density; returns (n, S) for x:(n,d), th:(S,d).

    Reference semantics: model_gaussian.py:4-11.
    """
    x = jnp.atleast_2d(x)
    th = jnp.atleast_2d(th)
    d = x.shape[1]
    # HIGHEST: this matrix is the Hilbert projection, and float32 dots at
    # the default precision run in TF32 on an H100 (models/logistic.py)
    hi = jax.lax.Precision.HIGHEST
    xS = jnp.dot(x, Siginv, precision=hi)            # (n, d)
    xSx = jnp.sum(xS * x, axis=1)                    # (n,)
    thS = jnp.dot(th, Siginv, precision=hi)          # (S, d)
    thSth = jnp.sum(thS * th, axis=1)                # (S,)
    cross = jnp.dot(xS, th.T, precision=hi,
                    preferred_element_type=jnp.float32)  # (n, S)
    quad = xSx[:, None] + thSth[None, :] - 2.0 * cross
    return -0.5 * d * _LOG2PI - 0.5 * logdetSig - 0.5 * quad


def grad_x_log_likelihood(x: jax.Array, th: jax.Array, Siginv: jax.Array) -> jax.Array:
    """Gradient wrt the datapoint x; returns (n, S, d) (model_gaussian.py:12-15)."""
    x = jnp.atleast_2d(x)
    th = jnp.atleast_2d(th)
    return (th @ Siginv)[None, :, :] - (x @ Siginv)[:, None, :]


def kl_divergence(mu0: jax.Array, Sig0: jax.Array, mu1: jax.Array, Sig1inv: jax.Array) -> jax.Array:
    """KL( N(mu0, Sig0) || N(mu1, Sig1) ) with Sig1 given by its inverse.

    Reference semantics: model_gaussian.py:17-21.
    """
    d = mu0.shape[0]
    t1 = jnp.trace(Sig1inv @ Sig0)
    dmu = mu1 - mu0
    t2 = dmu @ (Sig1inv @ dmu)
    t3 = -jnp.linalg.slogdet(Sig1inv)[1] - jnp.linalg.slogdet(Sig0)[1]
    return 0.5 * (t1 + t2 + t3 - d)


def kl_divergence_np(mu0, Sig0, mu1, Sig1inv):
    """Float64 NumPy KL for experiment metrics.

    On ill-conditioned posteriors (e.g. the RBF linear-regression designs)
    the trace/logdet terms cancel to a value many orders of magnitude below
    their individual sizes — f32 slogdet noise can even drive the result
    negative — so drivers compute quality metrics on the host in f64.
    """
    import numpy as np

    mu0 = np.asarray(mu0, np.float64)
    Sig0 = np.asarray(Sig0, np.float64)
    mu1 = np.asarray(mu1, np.float64)
    Sig1inv = np.asarray(Sig1inv, np.float64)
    d = mu0.shape[0]
    t1 = np.trace(Sig1inv @ Sig0)
    dmu = mu1 - mu0
    t2 = dmu @ (Sig1inv @ dmu)
    t3 = -np.linalg.slogdet(Sig1inv)[1] - np.linalg.slogdet(Sig0)[1]
    return 0.5 * (t1 + t2 + t3 - d)


class WeightedPost(NamedTuple):
    mu: jax.Array       # posterior mean (d,)
    USig: jax.Array     # Sig = USig @ USig.T, upper triangular
    LSigInv: jax.Array  # SigInv = LSigInv @ LSigInv.T, lower triangular


def weighted_post(th0, Sig0inv, Siginv, x, w) -> WeightedPost:
    """Closed-form weighted Gaussian posterior (model_gaussian.py:23-30).

    Posterior precision = Sig0inv + (sum_i w_i) * Siginv;
    posterior mean solves  Prec mu = Sig0inv th0 + Siginv sum_i w_i x_i.
    Handles the empty-coreset case (all weights zero) identically to the
    reference: the mean falls back to the prior mean only when w has length
    zero there; here zero total weight yields the prior posterior naturally.
    """
    d = th0.shape[0]
    wsum = jnp.sum(w)
    prec = Sig0inv + wsum * Siginv
    LSigInv = jnp.linalg.cholesky(prec)
    eye = jnp.eye(d, dtype=LSigInv.dtype)
    USig = solve_triangular(LSigInv, eye, lower=True).T
    wx = jnp.sum(w[:, None] * jnp.atleast_2d(x), axis=0) if w.shape[0] > 0 else jnp.zeros(d, Sig0inv.dtype)
    rhs = Sig0inv @ th0 + Siginv @ wx
    mu = USig @ (USig.T @ rhs)
    return WeightedPost(mu, USig, LSigInv)


def sample_weighted_post(key, th0, Sig0inv, Siginv, x, w, n_samples: int) -> jax.Array:
    """Draw n_samples thetas from the closed-form weighted posterior.

    Avoids materializing the explicit covariance factor: with
    Prec = L L^T, the mean solves via cho_solve and samples are
    mu + L^{-T} eps (cov = L^{-T} L^{-1} = Prec^{-1}) — one Cholesky and
    two triangular solves instead of a dense triangular inverse.  This is
    the hot path of SparseVI's inner loop (a fresh posterior refit on every
    Adam step, reference sparsevi.py:70-74).
    """
    d = th0.shape[0]
    wsum = jnp.sum(w)
    prec = Sig0inv + wsum * Siginv
    L = jnp.linalg.cholesky(prec)
    wx = jnp.sum(w[:, None] * jnp.atleast_2d(x), axis=0) if w.shape[0] > 0 else jnp.zeros(d, prec.dtype)
    rhs = Sig0inv @ th0 + Siginv @ wx
    mu = solve_triangular(L.T, solve_triangular(L, rhs, lower=True), lower=False)
    eps = jax.random.normal(key, (n_samples, d), dtype=prec.dtype)
    return mu + solve_triangular(L.T, eps.T, lower=False).T


class PosteriorBasis(NamedTuple):
    """Joint diagonalization of (Sig0inv, Siginv) for O(d^2) posterior refits.

    The weighted posterior precision is the ONE-PARAMETER family
    ``prec(s) = Sig0inv + s * Siginv`` with ``s = sum_i w_i``
    (model_gaussian.py:23-30).  With ``L0 = chol(Sig0inv)``,
    ``A = L0^{-1} Siginv L0^{-T} = V diag(lam) V^T`` computed ONCE,
    ``prec(s) = U (I + s*lam) U^T`` for the fixed ``U = L0 V`` — so every
    refit (SparseVI/BPSVI run one per Adam step, reference sparsevi.py:70-74)
    becomes diagonal scaling + matmuls with NO per-step factorization.
    This removes the latency-bound d x d Cholesky from the inner loop and
    leaves only matmuls.
    """

    Uinv: jax.Array    # (d, d) = V^T L0^{-1};  U^{-1}
    UinvT: jax.Array   # (d, d) = Uinv.T;       U^{-T}
    lam: jax.Array     # (d,) eigenvalues of L0^{-1} Siginv L0^{-T}
    r0: jax.Array      # (d,) = Sig0inv @ th0 (prior part of the rhs)
    Siginv: jax.Array  # (d, d) likelihood precision (for the data rhs)


def posterior_basis(th0, Sig0inv, Siginv) -> PosteriorBasis:
    """One-time O(d^3) setup for :func:`weighted_post_basis` /
    :func:`sample_weighted_post_basis`."""
    th0 = jnp.asarray(th0)
    d = th0.shape[0]
    L0 = jnp.linalg.cholesky(Sig0inv)
    L0inv = solve_triangular(L0, jnp.eye(d, dtype=L0.dtype), lower=True)
    A = L0inv @ Siginv @ L0inv.T
    lam, V = jnp.linalg.eigh(0.5 * (A + A.T))
    Uinv = V.T @ L0inv
    return PosteriorBasis(Uinv, Uinv.T, lam, Sig0inv @ th0, jnp.asarray(Siginv))


def _basis_mu_scale(basis: PosteriorBasis, x, w):
    w = jnp.atleast_1d(w)
    s = jnp.sum(w)
    dinv = 1.0 / (1.0 + s * basis.lam)          # spectrum of prec(s)^{-1}
    if w.shape[0] > 0:
        wx = jnp.sum(w[:, None] * jnp.atleast_2d(x), axis=0)
    else:
        wx = jnp.zeros_like(basis.r0)
    rhs = basis.r0 + basis.Siginv @ wx
    mu = basis.UinvT @ (dinv * (basis.Uinv @ rhs))
    return mu, jnp.sqrt(dinv)


def weighted_post_basis(basis: PosteriorBasis, x, w):
    """Fast ``weighted_post``: returns ``(mu, F)`` with ``Sig = F @ F.T``.

    F is a general (non-triangular) covariance factor — equivalent to
    WeightedPost.USig wherever only the Gram matters (tangent features,
    sampling), which is every hot consumer.
    """
    mu, scale = _basis_mu_scale(basis, x, w)
    return mu, basis.UinvT * scale[None, :]


def sample_weighted_post_basis(key, basis: PosteriorBasis, x, w, n_samples: int) -> jax.Array:
    """Fast ``sample_weighted_post``: no per-call factorization.

    theta = mu + (eps * scale) @ Uinv  has covariance
    U^{-T} diag(scale^2) U^{-1} = prec(s)^{-1}.
    """
    mu, scale = _basis_mu_scale(basis, x, w)
    eps = jax.random.normal(key, (n_samples, mu.shape[0]), dtype=mu.dtype)
    return mu + (eps * scale[None, :]) @ basis.Uinv


def gen_synthetic(key, n: int, d: int, dtype=jnp.float32):
    """Synthetic dataset matching the gaussian driver (gaussian/main.py:85)."""
    th = jnp.ones(d, dtype)
    return th + jax.random.normal(key, (n, d), dtype)
