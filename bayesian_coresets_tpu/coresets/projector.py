"""Log-likelihood projectors: finite discretizations of the tangent space.

Covers the reference's ``bayesiancoresets/projector.py:4-32``.  A projector
maps each datapoint to a feature vector whose inner products approximate
(or, for exact projectors, equal) the Hilbert-space inner products between
log-likelihood functions — the vectors consumed by the snnls solvers and
the Monte-Carlo gradients of SparseVI/BatchPSVI.

Two layers:

- :class:`TangentFamily` — the pure-function protocol consumed by the
  jitted coreset cores.  ``make_ctx(key, wts, pts)`` builds a projection
  context from the current coreset (posterior samples for black-box
  projectors; refit posterior factors for exact ones), and
  ``project(ctx, query)`` maps query points to centered feature vectors.
  Both data and coreset points are projected under the SAME context within
  one build step, mirroring the reference's shared-sample semantics
  (reference coreset/sparsevi.py:23-42).
- :class:`Projector`/:class:`BlackBoxProjector` — the reference's stateful
  user API (reference projector.py:4-32), wrapping a TangentFamily.

Departures from the reference:
- samplers are keyed: ``sampler(key, n_samples, wts, pts)`` (explicit PRNG
  instead of the reference's global NumPy stream);
- ``project`` is jitted, batched over data, and returns fixed-shape arrays;
- gradient projections are centered over the *sample* axis.  (The reference
  centers ``glls`` over the parameter axis — ``glls.mean(axis=2)`` at
  projector.py:26 — which is inconsistent with the centering of ``lls`` over
  samples at projector.py:21; we center both over samples, matching the
  pseudocoreset construction in the PSVI paper.)
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class TangentFamily(NamedTuple):
    """Pure-function projector protocol for the jitted coreset cores.

    The optional WARM pair lets context rebuilds carry state between calls
    within one build loop — e.g. the previous Laplace mode, so each of
    SparseVI's per-Adam-step posterior refits (reference sparsevi.py:70-76)
    is a short Newton track of a slowly-moving optimum instead of a full
    solve from scratch.  ``init_carry(wts, pts)`` must return a FULLY
    CONVERGED carry for the current coreset (it runs once per ``build()``
    entry); ``make_ctx_warm`` then refreshes cheaply per step.
    """

    make_ctx: Callable                 # (key, wts, pts) -> ctx pytree
    project: Callable                  # (ctx, query_pts) -> (q, S) centered
    project_grad: Optional[Callable] = None   # (ctx, query_pts) -> (q, S, d)
    make_ctx_warm: Optional[Callable] = None  # (key, wts, pts, carry) -> (ctx, carry)
    init_carry: Optional[Callable] = None     # (wts, pts) -> carry pytree


def center_lls(lls: jax.Array) -> jax.Array:
    """Per-datum centering over samples (reference projector.py:21)."""
    return lls - jnp.mean(lls, axis=1, keepdims=True)


def center_glls(glls: jax.Array) -> jax.Array:
    """Per-datum/per-coordinate centering over samples (see module note)."""
    return glls - jnp.mean(glls, axis=1, keepdims=True)


def blackbox_family(sampler, projection_dimension: int, loglikelihood,
                    grad_loglikelihood=None, warm_sampler=None,
                    init_carry=None) -> TangentFamily:
    """TangentFamily from a posterior sampler + log-likelihood
    (the functional core of the reference's BlackBoxProjector).

    ``warm_sampler(key, n, wts, pts, carry) -> (samples, carry)`` plus
    ``init_carry(wts, pts) -> carry`` enable carried-state context rebuilds
    (e.g. Laplace-mode warm starts; see TangentFamily).
    """

    def make_ctx(key, wts, pts):
        return sampler(key, projection_dimension, wts, pts)

    def project(ctx, pts):
        return center_lls(loglikelihood(pts, ctx))

    project_grad = None
    if grad_loglikelihood is not None:
        def project_grad(ctx, pts):  # noqa: F811
            return center_glls(grad_loglikelihood(pts, ctx))

    make_ctx_warm = None
    if warm_sampler is not None:
        if init_carry is None:
            raise ValueError("warm_sampler requires init_carry")

        def make_ctx_warm(key, wts, pts, carry):  # noqa: F811
            return warm_sampler(key, projection_dimension, wts, pts, carry)

    return TangentFamily(make_ctx, project, project_grad, make_ctx_warm,
                         init_carry)


@partial(jax.jit, static_argnames=("family", "grad"))
def project(family: TangentFamily, ctx, pts: jax.Array, grad: bool = False):
    """Compute centered (and optionally gradient) projections (jitted)."""
    lls = family.project(ctx, pts)
    if not grad:
        return lls
    if family.project_grad is None:
        raise ValueError("grad projection requested but not provided")
    return lls, family.project_grad(ctx, pts)


class Projector:
    """Abstract stateful projector (reference projector.py:4-9)."""

    def project(self, pts, grad: bool = False):
        raise NotImplementedError

    def update(self, wts, pts):
        raise NotImplementedError


class FamilyProjector(Projector):
    """Stateful facade over any TangentFamily (ctx held between calls)."""

    def __init__(self, family: TangentFamily, key: jax.Array | None = None):
        self.family = family
        self._key = key if key is not None else jax.random.key(0)
        self._ctx = None
        self.update(jnp.zeros((0,)), jnp.zeros((0, 0)))

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def update(self, wts, pts):
        """Rebuild the projection context from the current coreset."""
        self._ctx = jax.jit(self.family.make_ctx)(
            self._next_key(), jnp.asarray(wts), jnp.asarray(pts))

    def project(self, pts, grad: bool = False):
        return project(self.family, self._ctx, jnp.asarray(pts), grad=grad)


class BlackBoxProjector(FamilyProjector):
    """Sampler + log-likelihood discretizer (reference projector.py:11-32).

    ``sampler(key, n_samples, wts, pts)`` must be jittable; the projector
    threads an internal PRNG key so repeated ``update`` calls draw fresh
    posterior samples (the reference advances the global NumPy stream).
    """

    def __init__(self, sampler, projection_dimension: int, loglikelihood,
                 grad_loglikelihood=None, key: jax.Array | None = None,
                 warm_sampler=None, init_carry=None):
        self.projection_dimension = int(projection_dimension)
        family = blackbox_family(sampler, self.projection_dimension,
                                 loglikelihood, grad_loglikelihood,
                                 warm_sampler=warm_sampler,
                                 init_carry=init_carry)
        super().__init__(family, key=key)

    @property
    def samples(self):
        return self._ctx
