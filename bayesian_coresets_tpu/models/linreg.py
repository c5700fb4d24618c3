"""Bayesian linear regression (conjugate, RBF-basis capable).

Covers the reference's ``examples/common/model_linreg.py:4-37``: Gaussian
likelihood with known noise variance sigsq, Gaussian prior, closed-form
weighted posterior via Cholesky, and the data-gradient used by pseudocoreset
optimization.  Rows z_i = [x_i, y_i] (features then response).

Model: y_i ~ N(x_i . th, sigsq), th ~ N(th0, Sig0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .gaussian import WeightedPost, kl_divergence  # shared Gaussian KL (model_linreg.py:19-24)

_LOG2PI = 1.8378770664093453

__all__ = [
    "log_likelihood",
    "grad_x_log_likelihood",
    "weighted_post",
    "weighted_post_lowrank",
    "lowrank_basis",
    "kl_divergence",
    "rbf_features",
]


def _split(z):
    z = jnp.atleast_2d(z)
    return z[:, :-1], z[:, -1]


def log_likelihood(z: jax.Array, th: jax.Array, sigsq) -> jax.Array:
    """(n, S) Gaussian regression log-likelihood (model_linreg.py:4-11).

    The residual is computed as (y - x.th)^2 rather than the reference's
    expanded y^2 - 2*pred*y + pred^2 — identical in exact arithmetic, but
    the expanded form cancels catastrophically in f32 when the posterior is
    concentrated (the centered projections underflow to zero).  The dot
    runs at HIGHEST precision: this matrix is the Hilbert projection, and
    float32 dots at the default precision run in TF32 on an H100.
    """
    x, y = _split(z)
    th = jnp.atleast_2d(th)
    pred = jnp.dot(x, th.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)               # (n, S)
    resid_sq = (y[:, None] - pred) ** 2
    return -0.5 * jnp.log(2.0 * jnp.pi * sigsq) - resid_sq / (2.0 * sigsq)


def grad_x_log_likelihood(z: jax.Array, th: jax.Array, sigsq) -> jax.Array:
    """(n, S, d+1) gradient wrt the full row z = [x, y].

    d/dx_j = (y - x.th) th_j / sigsq ; d/dy = -(y - x.th) / sigsq.
    NOTE: the reference (model_linreg.py:13-17) uses +1 for the d/dy entry,
    which is a sign slip; we implement the correct derivative (the reference
    never exercises this path in its drivers).
    """
    x, y = _split(z)
    th = jnp.atleast_2d(th)
    r = (y[:, None] - jnp.dot(x, th.T, preferred_element_type=jnp.float32)) / sigsq  # (n,S)
    dx = r[:, :, None] * th[None, :, :]
    dy = -r[:, :, None]
    return jnp.concatenate([dx, dy], axis=2)


def weighted_post(th0, Sig0inv, sigsq, z, w) -> WeightedPost:
    """Closed-form weighted posterior (model_linreg.py:26-37).

    Precision = Sig0inv + X^T diag(w) X / sigsq;
    mean solves Prec mu = Sig0inv th0 + X^T (w*y) / sigsq.

    Computed via QR of the stacked weighted design [sqrt(w)X/sigma; L0^T]
    rather than Cholesky of the normal equations: the RBF design matrices of
    the linear_regression experiment have condition numbers far beyond f32's
    reach when squared (the reference gets away with the normal equations
    only because it runs in f64).
    """
    x, y = _split(z)
    d = th0.shape[0]
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    L0 = jnp.linalg.cholesky(Sig0inv)                 # Sig0inv = L0 L0^T
    srt = jnp.sqrt(sigsq)
    B = jnp.concatenate([sw[:, None] * x / srt, L0.T], axis=0)
    c = jnp.concatenate([sw * y / srt, L0.T @ th0], axis=0)
    Q, R = jnp.linalg.qr(B, mode="reduced")           # prec = R^T R
    # sign-normalize so R has positive diagonal (unique upper-tri factor)
    s = jnp.sign(jnp.where(jnp.diag(R) == 0, 1.0, jnp.diag(R)))
    R = s[:, None] * R
    LSigInv = R.T                                     # lower; prec = L L^T
    eye = jnp.eye(d, dtype=R.dtype)
    USig = solve_triangular(R, eye, lower=False)      # Sig = USig USig^T
    # least-squares mean: mu = R^{-1} Q^T c (never forms B^T B or B^T c)
    mu = solve_triangular(R, s * (Q.T @ c), lower=False)
    return WeightedPost(mu, USig, LSigInv)


def sample_weighted_post(key, th0, Sig0inv, sigsq, z, w, n_samples: int) -> jax.Array:
    """Samples mu + R^{-1} eps (cov = R^{-1} R^{-T} = Prec^{-1})."""
    post = weighted_post(th0, Sig0inv, sigsq, z, w)
    eps = jax.random.normal(key, (n_samples, th0.shape[0]), dtype=post.USig.dtype)
    R = post.LSigInv.T
    return post.mu + solve_triangular(R, eps.T, lower=False).T


class LowRankBasis(NamedTuple):
    """One-time prior factorization for :func:`weighted_post_lowrank`."""

    L0inv: jax.Array    # (d, d) with Sig0inv = L0 L0^T
    L0invT: jax.Array   # (d, d)
    r0: jax.Array       # (d,) = Sig0inv @ th0
    sigsq: jax.Array    # noise variance (scalar)


def lowrank_basis(th0, Sig0inv, sigsq) -> LowRankBasis:
    th0 = jnp.asarray(th0)
    d = th0.shape[0]
    L0 = jnp.linalg.cholesky(Sig0inv)
    L0inv = solve_triangular(L0, jnp.eye(d, dtype=L0.dtype), lower=True)
    return LowRankBasis(L0inv, L0inv.T, Sig0inv @ th0, jnp.asarray(sigsq))


def weighted_post_lowrank(basis: LowRankBasis, z, w):
    """Weighted posterior via a RANK-m Woodbury update of the prior.

    The coreset design has only m = len(w) rows, so
    ``prec = Sig0inv + X^T diag(w) X / sigsq = L0 (I + W^T W) L0^T`` with
    ``W = diag(sqrt(w)) X L0^{-T} / sigma`` (m, d): an eigh of the (m, m)
    Gram replaces the (m+d, d) QR on SparseVI's per-Adam-step critical path
    (reference sparsevi.py:70-74) — everything else is matmuls.

    Returns ``(mu, F)`` with ``Sig = F F^T`` (non-triangular factor; valid
    wherever only the Gram matters — tangent features, sampling).
    NOTE: the Gram squares W's conditioning, so for EXTREMELY
    ill-conditioned designs (lam_max/lam_min beyond ~1/eps_f32) prefer the
    QR path (:func:`weighted_post`); the exact-metric computations always
    use it.
    """
    x, y = _split(z)
    m = x.shape[0]
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    W = (sw[:, None] * x) @ basis.L0invT / jnp.sqrt(basis.sigsq)   # (m, d)
    G = W @ W.T
    lam, U = jnp.linalg.eigh(0.5 * (G + G.T))                      # (m,), (m, m)
    lam = jnp.maximum(lam, 0.0)
    tol = 1e-7 * jnp.maximum(jnp.max(lam), 1e-30)
    mask = lam > tol
    lam_safe = jnp.where(mask, lam, 1.0)
    V = (W.T @ U) / jnp.sqrt(lam_safe)[None, :]                    # (d, m)
    V = jnp.where(mask[None, :], V, 0.0)
    c_inv = jnp.where(mask, lam / (1.0 + lam), 0.0)
    c_half = jnp.where(mask, 1.0 - 1.0 / jnp.sqrt(1.0 + lam), 0.0)

    rhs = basis.r0 + x.T @ (w * y) / basis.sigsq
    t = basis.L0inv @ rhs
    t = t - V @ (c_inv * (V.T @ t))                                # (I+W^TW)^{-1}
    mu = basis.L0invT @ t
    F = basis.L0invT - ((basis.L0invT @ V) * c_half[None, :]) @ V.T
    return mu, F


def rbf_features(x: jax.Array, centers: jax.Array, scales: jax.Array) -> jax.Array:
    """Multi-scale RBF basis expansion used by the linear_regression driver
    (reference examples/linear_regression/main.py:80-108): features
    exp(-||x - c||^2 / (2 s^2)) for every (center, scale) pair, plus a
    constant column appended by the caller if desired.

    x: (n, p) raw inputs; centers: (k, p); scales: (m,).
    Returns (n, k*m) features.
    """
    sq = jnp.sum((x[:, None, :] - centers[None, :, :]) ** 2, axis=-1)   # (n, k)
    feats = jnp.exp(-sq[:, :, None] / (2.0 * scales[None, None, :] ** 2))
    return feats.reshape(x.shape[0], -1)
