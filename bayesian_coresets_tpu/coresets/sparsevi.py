"""SparseVI: greedy KL-minimizing coresets with Monte-Carlo gradients.

Covers the reference's ``bayesiancoresets/coreset/sparsevi.py:6-79``.  Each
build iteration (i) rebuilds the projection context from the current coreset
approximation (posterior refit + fresh samples for black-box projectors;
closed-form factors for exact ones), greedily selects the datapoint whose
centered feature vector best correlates with the residual, then (ii)
re-optimizes all active weights with projected Adam where *every* gradient
step rebuilds the context (reference sparsevi.py:69-76 via
projector.py:31-32).

Design: the entire ``build(itrs)`` — greedy selection, posterior
refits (closed-form or jittable Newton-Laplace), fresh Monte-Carlo
projections inside every Adam step — is ONE jitted ``lax.while_loop`` whose
inner optimizer is a ``lax.scan``; coreset storage is a fixed-capacity slot
array (idcs == -1 marks empty) so shapes stay static while the support grows.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.opt import nn_opt
from ..utils import config
from .coreset import Coreset
from .projector import FamilyProjector, TangentFamily

_NEG_INF = -jnp.inf


def resolve_family(ll_projector) -> TangentFamily:
    if isinstance(ll_projector, TangentFamily):
        return ll_projector
    if isinstance(ll_projector, FamilyProjector):
        return ll_projector.family
    raise TypeError(
        "ll_projector must be a TangentFamily or FamilyProjector/BlackBoxProjector")


def _gather_pts(data, idcs):
    return data[jnp.clip(idcs, 0, data.shape[0] - 1)]


def _init_carry(data, family: TangentFamily, wts, idcs, size):
    """Carried context state at build entry: fully converged for the current
    coreset (see TangentFamily.init_carry); a dummy for cold families."""
    if family.init_carry is None:
        return jnp.zeros((0,), data.dtype)
    mask = jnp.arange(wts.shape[0]) < size
    return family.init_carry(jnp.where(mask, wts, 0.0), _gather_pts(data, idcs))


def _projections(data, family: TangentFamily, key, w, idcs, size, n_sub,
                 carry, grad: bool = False):
    """Reference _get_projection (sparsevi.py:23-42): rebuild the context,
    project a (sub)sample of the data and the current coreset points.

    ``carry`` threads warm-start state (e.g. the previous Laplace mode)
    between context rebuilds when the family supports it."""
    n = data.shape[0]
    Mmax = w.shape[0]
    mask = jnp.arange(Mmax) < size
    pts = _gather_pts(data, idcs)
    k1, k2 = jax.random.split(key)
    if family.make_ctx_warm is not None:
        ctx, carry = family.make_ctx_warm(k1, jnp.where(mask, w, 0.0), pts, carry)
    else:
        ctx = family.make_ctx(k1, jnp.where(mask, w, 0.0), pts)
    if n_sub is None:
        sub_idcs = None
        vecs = family.project(ctx, data)
        scale = 1.0
    else:
        sub_idcs = jax.random.randint(k2, (n_sub,), 0, n)
        vecs = family.project(ctx, data[sub_idcs])
        scale = n / n_sub
    corevecs = family.project(ctx, pts)
    pgrads = family.project_grad(ctx, pts) if grad else None
    return vecs, scale, sub_idcs, corevecs, pgrads, mask, carry


def _select(data, family, key, wts, idcs, size, n_sub_sel, carry):
    """Greedy residual-correlation selection (reference sparsevi.py:44-67)."""
    vecs, scale, sub_idcs, corevecs, _, mask, carry = _projections(
        data, family, key, wts, idcs, size, n_sub_sel, carry)
    S = vecs.shape[1]
    Mmax = wts.shape[0]
    wmask = jnp.where(mask, wts, 0.0)
    resid = scale * jnp.sum(vecs, axis=0) - wmask @ corevecs

    vnorm = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
    corrs = jnp.where(vnorm > 0,
                      (vecs @ resid) / jnp.where(vnorm > 0, vnorm, 1.0) / S,
                      _NEG_INF)
    cnorm = jnp.sqrt(jnp.sum(corevecs * corevecs, axis=1))
    corecorrs = jnp.where(mask & (cnorm > 0),
                          jnp.abs(corevecs @ resid) / jnp.where(cnorm > 0, cnorm, 1.0) / S,
                          _NEG_INF)

    f_local = jnp.argmax(corrs)
    f = sub_idcs[f_local] if sub_idcs is not None else f_local
    take_new = (size == 0) | (jnp.max(corrs) > jnp.max(corecorrs))
    present = jnp.any(mask & (idcs == f))           # sparsevi.py:59 dedup
    add = take_new & ~present & (size < Mmax)
    slot = jnp.minimum(size, Mmax - 1)
    idcs = jnp.where(add, idcs.at[slot].set(f), idcs)
    wts = jnp.where(add, wts.at[slot].set(0.0), wts)
    return wts, idcs, size + add.astype(size.dtype), carry


def _optimize(data, family, key, wts, idcs, size, n_sub_opt, opt_itrs,
              step_sched, carry):
    """Re-solve all active weights; each Adam step rebuilds the context
    (reference sparsevi.py:69-76), warm-starting from the carried state."""
    Mmax = wts.shape[0]
    mask = jnp.arange(Mmax) < size

    def grad_fn(w, k, carry):
        vecs, scale, _, corevecs, _, _, carry = _projections(
            data, family, k, w, idcs, size, n_sub_opt, carry)
        resid = scale * jnp.sum(vecs, axis=0) - (jnp.where(mask, w, 0.0)) @ corevecs
        g = -(corevecs @ resid) / vecs.shape[1]
        return jnp.where(mask, g, 0.0), carry

    w, carry = nn_opt(wts, grad_fn, key, nn_mask=None, opt_itrs=opt_itrs,
                      step_sched=step_sched, aux0=carry)
    return jnp.where(mask, w, 0.0), carry


@partial(jax.jit, static_argnames=("family", "n_sub_sel", "n_sub_opt",
                                   "opt_itrs", "step_sched"))
def svi_build(data, wts, idcs, size, key, itrs, *, family: TangentFamily,
              n_sub_sel, n_sub_opt, opt_itrs: int, step_sched):
    """Run ``itrs`` select+optimize rounds inside one compiled while_loop."""

    def cond(state):
        return state[-1] < itrs

    def body(state):
        w, ix, sz, k, carry, i = state
        k, k1, k2 = jax.random.split(k, 3)
        w, ix, sz, carry = _select(data, family, k1, w, ix, sz, n_sub_sel, carry)
        w, carry = _optimize(data, family, k2, w, ix, sz, n_sub_opt, opt_itrs,
                             step_sched, carry)
        return (w, ix, sz, k, carry, i + 1)

    carry0 = _init_carry(data, family, wts, idcs, size)
    wts, idcs, size, key, _, _ = jax.lax.while_loop(
        cond, body, (wts, idcs, size, key, carry0, jnp.int32(0)))
    return wts, idcs, size, key


@partial(jax.jit, static_argnames=("family", "n_sub_opt", "opt_itrs", "step_sched"))
def svi_optimize(data, wts, idcs, size, key, *, family, n_sub_opt,
                 opt_itrs, step_sched):
    key, k = jax.random.split(key)
    carry = _init_carry(data, family, wts, idcs, size)
    wts, _ = _optimize(data, family, k, wts, idcs, size, n_sub_opt, opt_itrs,
                       step_sched, carry)
    return wts, key


@partial(jax.jit, static_argnames=("family", "n_sub"))
def svi_error_pair(data, w_old, w_new, idcs, size, key, *, family, n_sub):
    """(error(w_old), error(w_new)) under ONE shared context built from
    ``w_old`` — the like-for-like comparison optimize() needs: both
    residual norms live in the same tangent space with the same Monte-Carlo
    samples (common random numbers), so their difference reflects the
    weight change alone, not the measure's dependence on the weights (a
    corrupted w that concentrates its own refit posterior can shrink a
    self-measured estimate)."""
    carry = _init_carry(data, family, w_old, idcs, size)
    vecs, scale, _, corevecs, _, mask, _ = _projections(
        data, family, key, w_old, idcs, size, n_sub, carry)
    S = vecs.shape[1]
    base = scale * jnp.sum(vecs, axis=0)

    def e(w):
        resid = base - jnp.where(mask, w, 0.0) @ corevecs
        return jnp.sqrt(jnp.sum(resid * resid) / S)

    return e(w_old), e(w_new)


@partial(jax.jit, static_argnames=("family", "n_sub"))
def svi_error(data, wts, idcs, size, key, *, family, n_sub):
    """Monte-Carlo estimate of the Hilbert residual norm
    ||sum_i ell_i - sum_m w_m ell_m|| / sqrt(S) under the current coreset
    posterior — the quantity SparseVI's selection/optimization drives to
    zero.  (The reference's error() is an unimplemented TODO returning 0,
    sparsevi.py:78; this estimator is the natural computable extension.)"""
    carry = _init_carry(data, family, wts, idcs, size)
    vecs, scale, _, corevecs, _, mask, _ = _projections(
        data, family, key, wts, idcs, size, n_sub, carry)
    resid = scale * jnp.sum(vecs, axis=0) - jnp.where(mask, wts, 0.0) @ corevecs
    return jnp.sqrt(jnp.sum(resid * resid) / vecs.shape[1])


class SparseVICoreset(Coreset):
    """Stateful facade with the reference's API (sparsevi.py:7-14)."""

    def __init__(self, data, ll_projector, n_subsample_select=None,
                 n_subsample_opt=None, opt_itrs: int = 100,
                 step_sched=lambda i: 1.0 / (1.0 + i), seed: int = 0,
                 capacity: int | None = None):
        super().__init__()
        self.data = jnp.asarray(data, config.default_dtype())
        n = self.data.shape[0]
        self.family = resolve_family(ll_projector)
        self.n_subsample_select = None if n_subsample_select is None else min(n, int(n_subsample_select))
        self.n_subsample_opt = None if n_subsample_opt is None else min(n, int(n_subsample_opt))
        self.opt_itrs = int(opt_itrs)
        self.step_sched = step_sched
        self._seed = seed
        self._key = jax.random.key(seed)
        # slot capacity doubles on demand, which recompiles the build core at
        # every new shape; passing the final target size up front (e.g. the
        # driver's coreset_size_max) compiles once for the whole sweep
        self._init_cap = int(capacity) if capacity is not None else 0
        self._cap = 0
        self._wts = jnp.zeros((0,), self.data.dtype)
        self._idcs = jnp.full((0,), -1, jnp.int32)
        self._size = jnp.int32(0)
        if self._init_cap:
            self._ensure_capacity(self._init_cap)

    def reset(self):
        self._key = jax.random.key(self._seed)
        self._cap = 0
        self._wts = jnp.zeros((0,), self.data.dtype)
        self._idcs = jnp.full((0,), -1, jnp.int32)
        self._size = jnp.int32(0)
        if self._init_cap:
            self._ensure_capacity(self._init_cap)
        super().reset()

    def save(self, path: str):
        """Checkpoint (wts, idcs, size, key) for incremental-build resume."""
        from ..utils import checkpoint
        checkpoint.save(path, (self._wts, self._idcs, self._size, self._key))

    def restore(self, path: str):
        from ..utils import checkpoint
        leaves, _ = checkpoint.load(path)
        self._wts, self._idcs, self._size, self._key = (
            jnp.asarray(leaves[0]), jnp.asarray(leaves[1], jnp.int32),
            jnp.int32(leaves[2]), leaves[3])
        self._cap = int(self._wts.shape[0])
        self._sync()

    def _ensure_capacity(self, extra: int):
        need = int(self._size) + extra
        if need <= self._cap:
            return
        new_cap = max(8, 1 << int(np.ceil(np.log2(need))))
        if self._cap > 0:
            # the slot arrays are about to change shape, which recompiles
            # the whole jitted build core — an incremental sweep that grows
            # past capacity k times pays k multi-second compiles
            self.log.warning(
                f"coreset capacity regrowing {self._cap} -> {new_cap}: the "
                "build core recompiles at every new capacity.  Pass "
                "capacity=<final coreset size> at construction (e.g. the "
                "sweep's largest M) to compile once for the whole sweep.")
        self._wts = jnp.zeros((new_cap,), self.data.dtype).at[: self._cap].set(self._wts)
        self._idcs = jnp.full((new_cap,), -1, jnp.int32).at[: self._cap].set(self._idcs)
        self._cap = new_cap

    def _sync(self):
        sz = int(self._size)
        w = np.asarray(self._wts[:sz])
        ix = np.asarray(self._idcs[:sz], dtype=np.int64)
        self.wts = w
        self.idcs = ix
        self.pts = np.asarray(self.data)[ix] if sz else np.array([])

    def _build(self, itrs: int):
        self._ensure_capacity(itrs)
        self._key, k = jax.random.split(self._key)
        self._wts, self._idcs, self._size, _ = svi_build(
            self.data, self._wts, self._idcs, self._size, k, jnp.int32(itrs),
            family=self.family,
            n_sub_sel=self.n_subsample_select, n_sub_opt=self.n_subsample_opt,
            opt_itrs=self.opt_itrs, step_sched=self.step_sched)
        self._sync()

    def _optimize(self):
        self._key, k = jax.random.split(self._key)
        self._wts, _ = svi_optimize(
            self.data, self._wts, self._idcs, self._size, k,
            family=self.family, n_sub_opt=self.n_subsample_opt,
            opt_itrs=self.opt_itrs, step_sched=self.step_sched)
        self._sync()

    # relative slack for the CRN rollback check: with common random numbers
    # the sampling noise is shared between the before/after estimates, so
    # what remains is the (small) dependence of the MC measure on the
    # updated weights — a genuine optimizer failure moves the error by far
    # more than this
    _CRN_SLACK = 1e-3

    def optimize(self):
        """Weight re-optimization with a common-random-number rollback.

        The reference's base-class contract (coreset.py:47-64) rolls back
        any optimize() that increases error(); its SparseVI error() is an
        unimplemented 0.0 so the check never fires there.  Our Monte-Carlo
        estimate would trip it on sampling noise with independent draws and
        can be gamed by the measure's own weight dependence — so BOTH
        residual norms are evaluated in one shared tangent space built from
        the pre-optimize weights with one shared key (common random
        numbers, see svi_error_pair): the comparison isolates the weight
        change.
        """
        if self._cap == 0 or int(self._size) == 0:
            self._optimize()
            return
        self._key, k_err = jax.random.split(self._key)
        old = (self._wts, self._idcs, self._size)
        self._optimize()
        prev_cost, new_cost = (float(v) for v in svi_error_pair(
            self.data, old[0], self._wts, self._idcs, self._size, k_err,
            family=self.family, n_sub=self.n_subsample_opt))
        if new_cost > prev_cost * (1.0 + self._CRN_SLACK + config.TOL):
            self.log.warning(
                f"optimize() increased error: prev = {prev_cost}, "
                f"new = {new_cost} (CRN estimate); rolling back")
            self._wts, self._idcs, self._size = old
            self._sync()
            self.reached_numeric_limit = True

    def error(self) -> float:
        """MC estimate of the Hilbert residual norm (see svi_error).

        The reference returns 0.0 here (unimplemented TODO, sparsevi.py:78);
        this estimator is strictly more informative while remaining cheap
        (one posterior refit + projection).  Returns 0.0 for an empty
        coreset capacity to preserve the base-class optimize() contract.
        """
        if self._cap == 0:
            return 0.0
        self._key, k = jax.random.split(self._key)
        return float(svi_error(self.data, self._wts, self._idcs, self._size, k,
                               family=self.family, n_sub=self.n_subsample_opt))
