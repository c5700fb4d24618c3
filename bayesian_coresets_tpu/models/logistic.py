"""Bayesian logistic regression with the z = y*x folding trick.

Covers the reference's ``examples/common/model_lr.py:3-116``: stable
log-likelihood, standard-normal prior, closed-form gradients/Hessians in
theta and z, and the weighted log-joint.  The reference's manual
``log1p(exp)`` branch guards become ``jax.nn.softplus`` /
``jax.nn.sigmoid`` — branch-free, stable, and fusable.

Data convention: each row z_i = y_i * x_i with y in {-1, +1}, so
  log p(y_i | x_i, th) = -softplus(-z_i . th).
Prior: th ~ N(0, I).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LOG2PI = 1.8378770664093453


def _logits(z: jax.Array, th: jax.Array) -> jax.Array:
    z = jnp.atleast_2d(z)
    th = jnp.atleast_2d(th)
    # accumulate at (at least) the input precision: forcing f32 here would
    # silently downcast the f64 log-density island used by mcmc.run.
    # HIGHEST: these logits are the Hilbert projection, and the TF32 that
    # XLA:GPU uses for float32 at the default precision errs by ~5e-4 of
    # its scale (measured on an H100)
    acc = jnp.promote_types(z.dtype, jnp.float32)
    return jnp.dot(z, th.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=acc)  # (n, S)


def log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S) log-likelihood matrix (model_lr.py:25-32 semantics)."""
    return -jax.nn.softplus(-_logits(z, th))


def _softplus_diff(p: jax.Array, q: jax.Array) -> jax.Array:
    """softplus(p) - softplus(q) without large-magnitude cancellation.

    Identity: log(1+e^p) - log(1+e^q) = log1p(sigmoid(q) * expm1(p - q)),
    exact for all p, q.  Evaluated that way the result carries relative
    error of its own (small) magnitude instead of absolute error at the
    ulp of softplus(p) ~ |p| — the difference matters when a weighted sum
    amplifies per-datum rounding into O(1) Hamiltonian noise (see
    mcmc.weighted.weighted_logdensity).  For |p - q| > 30 the identity's
    expm1 would overflow where sigmoid underflows (inf * 0), but there is
    no cancellation to avoid at that distance, so direct subtraction takes
    over.
    """
    d = p - q
    # evaluate with a NON-NEGATIVE expm1 argument either way: for d <= -17,
    # f32 expm1(d) rounds to exactly -1 while sigmoid(q) rounds to 1, so the
    # naive one-sided form hits log1p(-1) = -inf (and NaN gradients through
    # jnp.where) inside its selected branch.  Flipping the roles of p and q
    # for negative d keeps log1p's argument in [0, inf).
    da = jnp.clip(jnp.abs(d), 0.0, 30.0)
    pos = jnp.log1p(jax.nn.sigmoid(q) * jnp.expm1(da))
    neg = -jnp.log1p(jax.nn.sigmoid(p) * jnp.expm1(da))
    stable = jnp.where(d >= 0, pos, neg)
    direct = jax.nn.softplus(p) - jax.nn.softplus(q)
    return jnp.where(jnp.abs(d) < 30.0, stable, direct)


def log_likelihood_diff(z: jax.Array, th: jax.Array, ref: jax.Array) -> jax.Array:
    """(n, S) of ll(z, th) - ll(z, ref), computed stably.

    Used by the weighted-MCMC mode-relative density: naive subtraction of
    two log-likelihood matrices cancels catastrophically once |ll| grows
    past ~1e4 (f32 ulp ~ 1e-3 there, amplified by coreset weights into
    O(1) energy noise); this form keeps each per-datum difference accurate
    relative to its own magnitude.
    """
    a = _logits(z, th)                               # (n, S)
    b = _logits(z, jnp.atleast_2d(ref))[:, :1]       # (n, 1)
    # ll = -softplus(-v): diff = softplus(-b) - softplus(-a)
    return _softplus_diff(-b, -a)


def log_prior(th: jax.Array) -> jax.Array:
    th = jnp.atleast_2d(th)
    return -0.5 * th.shape[1] * _LOG2PI - 0.5 * jnp.sum(th**2, axis=1)


def log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    """(S,) weighted log-joint: sum_i w_i ll_i(th) + log prior (model_lr.py:39-40)."""
    return jnp.sum(wts[:, None] * log_likelihood(z, th), axis=0) + log_prior(th)


def grad_th_log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S, d): d/dth -softplus(-z.th) = sigmoid(-z.th) * z (model_lr.py:42-49)."""
    s = jax.nn.sigmoid(-_logits(z, th))              # (n, S)
    return s[:, :, None] * jnp.atleast_2d(z)[:, None, :]


def grad_z_log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S, d): gradient wrt the (folded) datapoint z (model_lr.py:51-58)."""
    s = jax.nn.sigmoid(-_logits(z, th))
    return s[:, :, None] * jnp.atleast_2d(th)[None, :, :]


def grad_th_log_prior(th: jax.Array) -> jax.Array:
    return -jnp.atleast_2d(th)


def grad_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    """(S, d) gradient of the weighted log-joint (model_lr.py:63-64)."""
    return grad_th_log_prior(th) + jnp.einsum(
        "n,nsd->sd", wts, grad_th_log_likelihood(z, th)
    )


def _sig_pp(z, th):
    """sigmoid'(logit) = sig*(1-sig), batched (n, S)."""
    s = jax.nn.sigmoid(_logits(z, th))
    return s * (1.0 - s)


def hess_th_log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S, d, d) per-datum Hessians (model_lr.py:66-73)."""
    z = jnp.atleast_2d(z)
    m = _sig_pp(z, th)
    return -m[:, :, None, None] * z[:, None, :, None] * z[:, None, None, :]


def hess_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    """(S, d, d) Hessian of the weighted log-joint as one contraction.

    Reference semantics (model_lr.py:79-80) but computed as
    -I - (w*m Z)^T Z instead of materializing the (n,S,d,d) tensor.
    """
    z = jnp.atleast_2d(z)
    th2 = jnp.atleast_2d(th)
    m = _sig_pp(z, th2) * wts[:, None]               # (n, S)
    hess_ll = -jnp.einsum("ns,ni,nj->sij", m, z, z)
    eye = jnp.eye(z.shape[1], dtype=z.dtype)
    return hess_ll - eye[None, :, :]


def diag_hess_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    """(S, d) diagonal Hessian (model_lr.py:82-92)."""
    z = jnp.atleast_2d(z)
    m = _sig_pp(z, jnp.atleast_2d(th)) * wts[:, None]
    return -jnp.einsum("ns,ni->si", m, z**2) - 1.0


def gen_synthetic(key, n: int, d: int = 2, theta_scale: float = 3.0, dtype=jnp.float32):
    """Synthetic LR data (model_lr.py:15-23): returns folded Z = y*x."""
    kx, ky = jax.random.split(key)
    th = theta_scale * jnp.ones(d, dtype)
    x = jax.random.normal(kx, (n, d), dtype)
    ps = jax.nn.sigmoid(x @ th)
    y = jnp.where(jax.random.uniform(ky, (n,)) <= ps, 1.0, -1.0).astype(dtype)
    return y[:, None] * x
