"""Bayesian Poisson regression with softplus rate link.

Covers the reference's ``examples/common/model_poiss.py:4-113``: rate
lambda = softplus(x . th), counts y ~ Poisson(lambda), th ~ N(0, I).
The reference's hand-rolled log-log stability guard ``compute_s``
(model_poiss.py:25-30) becomes branch-free ``jnp.where`` over
``jax.nn.softplus``; all (n, S) matrices come from a single x @ th.T matmul.

Data convention: each row z_i = [x_i, y_i] (covariates then count).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

_LOG2PI = 1.8378770664093453
# Below this logit, log(softplus(v)) ~= v to ~1e-11 and f32 softplus underflows.
_V_FLOOR = -25.0


def _split(z):
    z = jnp.atleast_2d(z)
    return z[:, :-1], z[:, -1]


def _logits(x, th):
    th = jnp.atleast_2d(th)
    # accumulate at (at least) the input precision: forcing f32 here would
    # silently downcast the f64 log-density island used by mcmc.run.
    # HIGHEST: these logits feed the Hilbert projection, and float32 dots
    # at the default precision run in TF32 on an H100 (models/logistic.py)
    acc = jnp.promote_types(x.dtype, jnp.float32)
    return jnp.dot(x, th.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=acc)  # (n, S)


def compute_s(th: jax.Array, x: jax.Array) -> jax.Array:
    """Stable log(softplus(x.th)); reference guard at model_poiss.py:25-30."""
    v = _logits(x, th)
    sp = jax.nn.softplus(v)
    return jnp.where(v > _V_FLOOR, jnp.log(jnp.maximum(sp, 1e-38)), v)


def log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S) Poisson log-likelihood (model_poiss.py:32-38)."""
    x, y = _split(z)
    v = _logits(x, th)
    s = compute_s(th, x)
    lam = jax.nn.softplus(v)
    return y[:, None] * s - gammaln(y + 1.0)[:, None] - lam


def log_likelihood_diff(z: jax.Array, th: jax.Array, ref: jax.Array) -> jax.Array:
    """(n, S) of ll(z, th) - ll(z, ref), computed stably.

    The mode-relative weighted density needs per-datum DIFFERENCES; naive
    subtraction cancels catastrophically for count data (|ll_i| ~ y log y
    reaches 1e3-1e4 here, and coreset weights multiply the resulting f32
    rounding into O(1) Hamiltonian noise — the mechanism that left
    biketrips/airportdelays coreset chains unconverged in float32).  Exact
    identities keep every term accurate relative to its own magnitude:

      lam(a) - lam(b)         = log1p(sigmoid(b) expm1(a-b))
      log lam(a) - log lam(b) = log1p((lam(a) - lam(b)) / lam(b))

    and gammaln(y+1) cancels exactly.  Falls back to direct subtraction
    outside the softplus guard region (v <= -25, where s ~= v and rates
    are ~1e-11 — no datapoint with y > 0 has posterior mass there).
    """
    from .logistic import _softplus_diff

    x, y = _split(z)
    va = _logits(x, th)                               # (n, S)
    vb = _logits(x, jnp.atleast_2d(ref))[:, :1]       # (n, 1)
    dlam = _softplus_diff(va, vb)
    lam_b = jnp.maximum(jax.nn.softplus(vb), 1e-38)
    ratio = jnp.maximum(dlam / lam_b, -1.0 + 1e-7)
    ds_stable = jnp.log1p(ratio)
    ds_direct = compute_s(th, x) - compute_s(jnp.atleast_2d(ref), x)[:, :1]
    ds = jnp.where((va > _V_FLOOR) & (vb > _V_FLOOR), ds_stable, ds_direct)
    return y[:, None] * ds - dlam


def log_prior(th: jax.Array) -> jax.Array:
    th = jnp.atleast_2d(th)
    return -0.5 * th.shape[1] * _LOG2PI - 0.5 * jnp.sum(th**2, axis=1)


def log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    return jnp.sum(wts[:, None] * log_likelihood(z, th), axis=0) + log_prior(th)


def _rate_score(z, th):
    """g = d/dv [y log lam - lam] = (y/lam - 1) * sigmoid(v), stabilized.

    sigmoid(v)/softplus(v) -> 1 as v -> -inf, so g -> y - lam smoothly; the
    reference guards the same cancellation at model_poiss.py:47-55.
    """
    x, y = _split(z)
    v = _logits(x, th)
    sig = jax.nn.sigmoid(v)
    lam = jax.nn.softplus(v)
    safe_lam = jnp.maximum(lam, 1e-30)
    ratio = jnp.where(v > _V_FLOOR, sig / safe_lam, 1.0)
    return y[:, None] * ratio - sig, x, v, sig, lam


def grad_th_log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S, d) gradient wrt theta (model_poiss.py:47-55)."""
    g, x, *_ = _rate_score(z, th)
    return g[:, :, None] * x[:, None, :]


def grad_z_log_likelihood(z: jax.Array, th: jax.Array) -> jax.Array:
    """(n, S, d) gradient wrt covariates x (count untouched; model_poiss.py:57-65)."""
    g, _, *_ = _rate_score(z, th)
    return g[:, :, None] * jnp.atleast_2d(th)[None, :, :]


def grad_th_log_prior(th: jax.Array) -> jax.Array:
    return -jnp.atleast_2d(th)


def grad_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    return grad_th_log_prior(th) + jnp.einsum("n,nsd->sd", wts, grad_th_log_likelihood(z, th))


def _rate_curvature(z, th):
    """h = d^2/dv^2 [y log lam - lam], stabilized (model_poiss.py:67-75).

    h = y * (sig(1-sig)lam - sig^2)/lam^2 - sig(1-sig); both terms vanish as
    v -> -inf, so the floor branch returns 0 there.
    """
    x, y = _split(z)
    v = _logits(x, th)
    sig = jax.nn.sigmoid(v)
    lam = jax.nn.softplus(v)
    safe_lam = jnp.maximum(lam, 1e-30)
    curv = (sig * (1.0 - sig) * safe_lam - sig**2) / safe_lam**2
    h = y[:, None] * jnp.where(v > _V_FLOOR, curv, 0.0) - sig * (1.0 - sig)
    return h, x


def hess_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    """(S, d, d) Hessian of the weighted log-joint via one einsum contraction."""
    h, x = _rate_curvature(z, th)
    hw = h * wts[:, None]
    hess_ll = jnp.einsum("ns,ni,nj->sij", hw, x, x)
    eye = jnp.eye(x.shape[1], dtype=x.dtype)
    return hess_ll - eye[None, :, :]


def diag_hess_th_log_joint(z: jax.Array, th: jax.Array, wts: jax.Array) -> jax.Array:
    h, x = _rate_curvature(z, th)
    return jnp.einsum("ns,ni->si", h * wts[:, None], x**2) - 1.0


def gen_synthetic(key, n: int, dtype=jnp.float32):
    """Synthetic Poisson data (model_poiss.py:19-23): z rows = [x, 1, y]."""
    kx, ky = jax.random.split(key)
    x1 = jax.random.normal(kx, (n,), dtype)
    x = jnp.stack([x1, jnp.ones(n, dtype)], axis=1)
    lam = jax.nn.softplus(x @ jnp.array([1.0, 0.0], dtype))
    y = jax.random.poisson(ky, lam).astype(dtype)
    return jnp.concatenate([x, y[:, None]], axis=1)
