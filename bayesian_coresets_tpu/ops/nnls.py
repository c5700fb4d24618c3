"""On-chip non-negative least squares.

Replaces the reference's scipy ``nnls`` (Fortran Lawson-Hanson, sequential
and data-dependent — reference snnls/snnls.py:87, snnls/orthopursuit.py:40)
with a fixed-iteration accelerated projected-gradient (FISTA + adaptive
restart) on the *gathered active-set* system: the active set is small
(≤ coreset size M), so the Gram matrix is a tiny (K, K) block and the
whole solve is a bounded-shape jittable loop.

For a convex problem FISTA converges to the same minimizer Lawson-Hanson
finds; the iteration count trades exactness for static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _power_iteration_sym(G: jax.Array, iters: int = 24) -> jax.Array:
    """Largest eigenvalue of a symmetric PSD matrix (Lipschitz constant)."""
    k = G.shape[0]
    v0 = jnp.full((k,), 1.0 / jnp.sqrt(k), G.dtype)

    def body(_, v):
        v = G @ v
        nrm = jnp.sqrt(jnp.sum(v * v))
        return v / jnp.where(nrm == 0, 1.0, nrm)

    v = jax.lax.fori_loop(0, iters, body, v0)
    return jnp.maximum(v @ (G @ v), 1e-12)


def nnls_gram(G: jax.Array, c: jax.Array, num_iters: int = 512,
              x0: jax.Array | None = None) -> jax.Array:
    """min_x 0.5 x^T G x - c^T x  s.t. x >= 0, via FISTA with restart.

    G: (K, K) PSD Gram matrix; c: (K,).
    """
    L = _power_iteration_sym(G)
    step = 1.0 / L
    x_init = jnp.zeros_like(c) if x0 is None else jnp.maximum(x0, 0.0)

    def body(_, carry):
        x, y, t = carry
        grad = G @ y - c
        x_new = jnp.maximum(y - step * grad, 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        mom = (t - 1.0) / t_new
        # adaptive restart: if momentum points uphill, reset it
        restart = jnp.dot(y - x_new, x_new - x) > 0
        mom = jnp.where(restart, 0.0, mom)
        t_new = jnp.where(restart, 1.0, t_new)
        y_new = x_new + mom * (x_new - x)
        return x_new, y_new, t_new

    x, _, _ = jax.lax.fori_loop(0, num_iters, body, (x_init, x_init, jnp.asarray(1.0, c.dtype)))
    return x


def nnls_rows(Aact: jax.Array, b: jax.Array, mask: jax.Array,
              num_iters: int = 512, x0: jax.Array | None = None) -> jax.Array:
    """NNLS on pre-gathered rows: min ||Aact^T x - b||, x >= 0.

    Aact: (K, S) gathered (already dequantized) active rows, zeroed at
    padding; mask: (K,) live-row mask.  The normal equations
    G = Aact Aact^T, c = Aact b reduce the solve to a (K, K) problem
    independent of n, so OMP/optimize() cost does not scale with dataset size.
    """
    G = jnp.dot(Aact, Aact.T, preferred_element_type=jnp.float32)
    # unit diagonal on padded rows keeps G nonsingular without affecting live rows
    G = G + jnp.diag(jnp.where(mask, 0.0, 1.0).astype(G.dtype))
    c = jnp.dot(Aact, b, preferred_element_type=jnp.float32)
    x = nnls_gram(G, c, num_iters=num_iters, x0=x0)
    return jnp.where(mask, x, 0.0)


def nnls_active_set(V: jax.Array, b: jax.Array, idcs: jax.Array, size,
                    num_iters: int = 512, x0: jax.Array | None = None) -> jax.Array:
    """NNLS restricted to active columns of A = V.T.

    V: (n, S) data-major projection matrix; idcs: (K,) padded active indices;
    size: number of live entries in idcs.  Returns (K,) weights (0 at padding).
    """
    K = idcs.shape[0]
    mask = jnp.arange(K) < size
    safe_idcs = jnp.where(mask, idcs, 0)
    Aact = jnp.where(mask[:, None], V[safe_idcs], 0.0)          # (K, S)
    return nnls_rows(Aact, b, mask, num_iters=num_iters, x0=x0)
