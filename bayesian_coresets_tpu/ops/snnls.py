"""Sparse non-negative least squares solvers as jitted state machines.

JAX redesign of the reference's ``bayesiancoresets/snnls`` package
(snnls/snnls.py, giga.py, frankwolfe.py, orthopursuit.py, sampling.py).

Key departures from the reference architecture:

- **One jit, M iterations.**  ``build`` runs the whole greedy loop inside a
  single ``lax.while_loop`` — no per-iteration host round trips.
- **Incremental O(S) reweighting.**  Every solver's weight update has the
  form ``w <- alpha*w; w[f] += beta``, so the cached residual image
  ``xw = A @ w`` updates as ``alpha*xw + delta*A[:, f]`` instead of a fresh
  O(S·n) matvec; an exact matvec refresh runs every ``REFRESH_EVERY``
  iterations to bound f32 drift.
- **Branchless numerics control flow.**  The reference's
  ``NumericalPrecisionError`` + try/except rollback/retry/latch
  (snnls/snnls.py:40-74) becomes a success flag per step: on failure the
  candidate state is discarded (``jnp.where``), a consecutive-failure
  counter increments, and two consecutive failures latch ``done`` —
  identical semantics, no exceptions.
- **Static shapes with validity masks.**  Padded/zero columns carry
  ``valid=False`` and can never be selected, so subsampled problems keep a
  fixed trace shape across trials.
- **Data-point-major layout.**  The projection matrix is stored as
  ``V = A.T`` with shape (n, S): scores for all n candidates are one
  (n,S)@(S,2) matmul, and the global argmax reduces over the sharded n
  axis.
- **Explicit-collective SPMD.**  Sharded builds run the same step functions
  INSIDE ``jax.shard_map`` (parallel/coreset.py) with static ``axes =
  (data_axis, proj_axis)`` threading: every data-dependent row access is an
  owner-shard ``dynamic_slice`` + one O(S) psum, the greedy argmax is a
  local argmax + an O(devices) exchange, and n-axis reductions are local
  partials + psum.  Per-iteration work is ONE streaming pass over the local
  V shard — the same per-point cost as the single-device build (GSPMD's
  automatic partitioning of the one-hot-masked formulation used in earlier
  revisions burned a second full-V pass per row read).

Row and column padding: reduced-precision selection copies and the
int8-resident buffer are padded to a multiple of 1024 rows and 128
columns.  The padding is correct on any backend (padded rows are invalid,
padded columns are zero); whether the GPU wants it at all is not measured
yet.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import config
from .nnls import nnls_rows

REFRESH_EVERY = 64  # exact xw = A@w recompute cadence (f32 drift control)
_NEG_INF = -jnp.inf
NORM_FLOOR = float(jnp.finfo(jnp.float32).eps)
# float32 dots whose results feed the error-monotonicity gate run at
# HIGHEST precision: at the default precision XLA:GPU computes float32
# products in TF32 (about 3e-4 relative error on an H100), far above the
# gate's TOL=1e-6 slack, and builds latch early.  The select dots stay at
# the default: they only rank candidates.
_GATE = jax.lax.Precision.HIGHEST


def above_norm_floor(norms, bnorm, mean_norm=None):
    """Rows a coreset constructor keeps selectable (host-side, numpy).

    The reference drops exactly-zero projections (hilbert.py:20-22).  Here
    a row is masked as a candidate only when it is negligible on BOTH of
    float32's scales:

    - the target: ``norm <= eps * ||b||``.  GIGA normalizes rows and
      reaches b with weights inversely proportional to their norms, so
      such a row needs a weight above 1/eps to carry b.  Saturated
      logistic points (|z.theta| >> 1: log-likelihood ~ -exp(-|z.theta|)
      at every sample) are such rows in a Laplace tangent space, where
      ||b|| stays O(d) as N grows; GIGA picks them for their direction and
      weights them 1e8 and up, which no float32 weighted log-density
      downstream carries (weighted NUTS on such a coreset returned NaN);
    - the rows: ``norm <= sqrt(eps) * mean_norm``, so its squared norm is
      below float32 resolution of an average row's.  This keeps the floor
      from growing with N when the rows are coherent (||b|| ~ N x the mean
      norm, e.g. raw vectors with a common mean): there ``eps * ||b||``
      alone would reach the mean row norm at N ~ 1/eps.

    ``mean_norm`` defaults to the mean of ``norms``; pass it when ``norms``
    holds padding or only part of the rows.  Masked rows stay in b.
    """
    norms = np.asarray(norms)
    if mean_norm is None:
        mean_norm = float(norms.mean(dtype=np.float64)) if norms.size else 0.0
    floor = min(NORM_FLOOR * float(bnorm), math.sqrt(NORM_FLOOR) * mean_norm)
    return norms > floor


class SNNLSConsts(NamedTuple):
    """Problem constants shared by all solvers."""

    V: jax.Array       # (n, S) = A.T, rows are per-datum feature vectors
    b: jax.Array       # (S,) target vector
    norms: jax.Array   # (n,) column norms ||A[:, i]|| (1 for invalid columns)
    bnorm: jax.Array   # scalar ||b||
    valid: jax.Array   # (n,) bool mask of selectable columns
    ps: jax.Array      # (n,) sampling probabilities (IS/US; zeros elsewhere)
    Vsel: jax.Array    # (n, S) select-phase copy of V.  Selection is an
    #                    argmax, so reduced precision only perturbs near-ties
    #                    while all weight/error arithmetic stays f32:
    #                    - bfloat16: half the HBM traffic of the score matmul
    #                    - int8: quarter traffic; rows stored PRE-NORMALIZED
    #                      and scaled to +-127 (the /norms division folds into
    #                      the dequantization constant), int8 dot
    #                    - EMPTY (0, S): selection reads V directly (bit-exact
    #                      reference behavior, and the int8-RESIDENT mode
    #                      where V itself is the quantized copy).  A zero-row
    #                      sentinel instead of aliasing V: two pytree leaves
    #                      pointing at one buffer would double the while-loop
    #                      carry accounting and OOM at beyond-HBM scale.


class SNNLSState(NamedTuple):
    """Mutable solver state carried through the build loop."""

    w: jax.Array       # (n,) weights
    xw: jax.Array      # (S,) cached A @ w
    cts: jax.Array     # (n,) selection counts (sampling solvers)
    idcs: jax.Array    # (K,) active-slot indices (OMP bookkeeping; size-0 else)
    size: jax.Array    # int32 number of active slots (OMP)
    itr: jax.Array     # int32 total iterations attempted (lifetime)
    fail: jax.Array    # int32 consecutive failed iterations
    done: jax.Array    # bool: numeric limit latched (snnls/snnls.py:66-69)
    key: jax.Array     # PRNG key (sampling solvers)


def _sampling_ps(norms, valid, sampling, dtype):
    """Column-sampling probabilities for the IS/US solvers."""
    if sampling == "importance":
        raw = jnp.where(valid, norms, 0.0)
        tot = jnp.sum(raw)
        nv = jnp.sum(valid)
        return jnp.where(tot > 0, raw / jnp.where(tot > 0, tot, 1.0),
                         jnp.where(valid, 1.0 / jnp.maximum(nv, 1), 0.0))
    if sampling == "uniform":
        nv = jnp.maximum(jnp.sum(valid), 1)
        return jnp.where(valid, 1.0 / nv, 0.0)
    # non-sampling solvers carry NO probability vector (size 0): a static
    # marker init_state uses to elide the dead (n,) counts carry
    return jnp.zeros(0, dtype=dtype)


@partial(jax.jit, static_argnames=("sampling", "select_dtype"))
def _make_consts(V, b, valid, sampling, select_dtype) -> SNNLSConsts:
    norms = jnp.sqrt(jnp.sum(V * V, axis=1))
    valid = valid & (norms > 0)
    norms = jnp.where(valid, norms, 1.0)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    ps = _sampling_ps(norms, valid, sampling, V.dtype)
    if select_dtype is None:
        Vsel = V[:0]
    else:
        if select_dtype == jnp.int8:
            Vn = V / norms[:, None]
            Vsel = jnp.clip(jnp.round(Vn * 127.0), -127, 127).astype(jnp.int8)
        else:
            Vsel = V.astype(select_dtype)
        # pad once to the row/column tile multiples (see module note) —
        # padded rows/cols are zero and masked out
        n, S = Vsel.shape
        np_rows = -(-n // 1024) * 1024
        Sp = -(-S // 128) * 128
        Vsel = jnp.pad(Vsel, ((0, np_rows - n), (0, Sp - S)))
    return SNNLSConsts(V, b, norms, bnorm, valid, ps, Vsel)


def make_consts(A: jax.Array, b: jax.Array, valid: jax.Array | None = None,
                sampling: str | None = None,
                select_dtype=None) -> SNNLSConsts:
    """Precompute solver constants from A (S, n) and b (S,).

    ``select_dtype=jnp.bfloat16`` stores a half-precision copy of V used
    only for the greedy-selection score matmuls (see SNNLSConsts.Vsel).
    """
    V = jnp.asarray(A).T
    b = jnp.asarray(b)
    if valid is None:
        valid = jnp.ones(V.shape[0], dtype=bool)
    return _make_consts(V, b, jnp.asarray(valid), sampling, select_dtype)


@partial(jax.jit, static_argnames=("sampling",))
def _finish_quantized(norms, b, valid, sampling):
    # the big int8 buffer stays OUT of this jit: passing it through would
    # copy it on return (no input/output aliasing without donation), which
    # at beyond-HBM scale is an instant OOM
    valid = valid & (norms > 0)
    norms = jnp.where(valid, norms, 1.0)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    ps = _sampling_ps(norms, valid, sampling, b.dtype)
    return norms, bnorm, valid, ps


def make_consts_quantized(Vq: jax.Array, norms: jax.Array, b: jax.Array,
                          valid: jax.Array | None = None,
                          sampling: str | None = None) -> SNNLSConsts:
    """int8-RESIDENT problem constants: beyond-f32-HBM construction.

    ``Vq`` (n, S) int8: each row is the corresponding V row normalized to
    unit length and scaled to ±127; ``norms`` (n,) f32 are the original row
    norms.  Only the int8 copy + f32 norms live in HBM — no f32 (n, S) is
    ever materialized, so datasets ~4x beyond the f32+int8 ceiling fit on
    one chip (see coresets/hilbert.py streamed construction).

    The same buffer serves selection (pre-normalized int8 score matmuls,
    exactly the ``select_dtype=int8`` path) and reweighting (single rows /
    small active-set gathers are dequantized on the fly via
    ``row = norms[f] * Vq[f] / 127``), trading ~0.4%-per-element reweight
    precision for the capacity.  Rows are padded to a multiple of 1024 and S
    to a multiple of 128; padded rows are invalid, padded columns are zero (b is
    zero-padded to match, which changes no inner product).
    """
    Vq = jnp.asarray(Vq)
    if Vq.dtype != jnp.int8:
        raise ValueError("make_consts_quantized requires an int8 matrix")
    n, S = Vq.shape
    norms = jnp.asarray(norms, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if valid is None:
        valid = jnp.ones(n, dtype=bool)
    np_rows = -(-n // 1024) * 1024
    Sp = -(-S // 128) * 128
    if (np_rows, Sp) != (n, S):
        # NOTE: this pad COPIES Vq — at beyond-HBM scale allocate the buffer
        # pre-padded (zero rows/cols, valid=False) and skip this branch, as
        # the streamed HilbertCoreset constructor does.
        Vq = jnp.pad(Vq, ((0, np_rows - n), (0, Sp - S)))
        norms = jnp.pad(norms, (0, np_rows - n), constant_values=1.0)
        valid = jnp.pad(valid, (0, np_rows - n), constant_values=False)
        b = jnp.pad(b, (0, Sp - S))
    norms, bnorm, valid, ps = _finish_quantized(norms, b, jnp.asarray(valid), sampling)
    return SNNLSConsts(Vq, b, norms, bnorm, valid, ps, Vq[:0])


def _is_quantized(consts: SNNLSConsts) -> bool:
    return consts.V.dtype == jnp.int8


# ---------------------------------------------------------------------------
# SPMD access primitives.
#
# ``axes`` is a static (data_axis, proj_axis) tuple of mesh axis names (or
# None entries / None overall).  When set, the caller is running INSIDE
# jax.shard_map (parallel/coreset.py): arrays are the per-device LOCAL
# shards — V (n/dd, S/dp), n-vectors (n/dd,), S-vectors (S/dp,) — and every
# cross-shard exchange below is an explicit collective:
#   - row / scalar reads by global index: the owning shard along the data
#     axis extracts by LOCAL dynamic_slice, everyone else contributes
#     zeros, one psum — O(S) (row) or O(1) (scalar) traffic, never a pass
#     over V (the one-hot masked formulation this replaces streamed the
#     whole local shard per read — a measured ~1.5x per-point work
#     inflation).
#   - argmax over the n axis: local argmax + an O(devices) all_gather of
#     (value, global index) pairs; first-max tie-break matches jnp.argmax.
#   - reductions over n / S: local partial + psum over the matching axis.
# ---------------------------------------------------------------------------


def _data_ax(axes):
    return axes[0] if axes else None


def _proj_ax(axes):
    return axes[1] if axes else None


def _psum_n(x, axes):
    """Sum-reduce a value whose summands are sharded along the data axis."""
    ax = _data_ax(axes)
    return jax.lax.psum(x, ax) if ax else x


def _psum_s(x, axes):
    """Sum-reduce a value whose summands are sharded along the proj axis."""
    ax = _proj_ax(axes)
    return jax.lax.psum(x, ax) if ax else x


def _shard_lo(nloc: int, axes):
    """Global index of this shard's first row along the data axis."""
    return jax.lax.axis_index(_data_ax(axes)) * nloc


def _v_row(consts: SNNLSConsts, f, axes=None) -> jax.Array:
    """Row V[f] in f32 (dequantized in int8-resident mode).

    SPMD: owner-shard dynamic_slice + one O(S) psum over the data axis (the
    result is the owner's local row plus zeros from every other shard, so
    the value is bit-identical to the single-device gather)."""
    if _data_ax(axes):
        nloc = consts.V.shape[0]
        lo = _shard_lo(nloc, axes)
        j = jnp.clip(f - lo, 0, nloc - 1)
        row = jax.lax.dynamic_slice_in_dim(consts.V, j, 1, axis=0)[0]
        mine = (f >= lo) & (f < lo + nloc)
        if _is_quantized(consts):
            nf = jax.lax.dynamic_slice_in_dim(consts.norms, j, 1)[0]
            row = row.astype(jnp.float32) * (nf * (1.0 / 127.0))
        row = jnp.where(mine, row, 0.0).astype(jnp.float32)
        return jax.lax.psum(row, _data_ax(axes))
    if _is_quantized(consts):
        return consts.V[f].astype(jnp.float32) * (consts.norms[f] * (1.0 / 127.0))
    return consts.V[f]


def _get1(x: jax.Array, f, axes=None) -> jax.Array:
    """x[f] for a data-sharded (n,)-vector; owner read + scalar psum."""
    if _data_ax(axes):
        nloc = x.shape[0]
        lo = _shard_lo(nloc, axes)
        j = jnp.clip(f - lo, 0, nloc - 1)
        v = jax.lax.dynamic_slice_in_dim(x, j, 1)[0]
        v = jnp.where((f >= lo) & (f < lo + nloc), v, 0)
        return jax.lax.psum(v, _data_ax(axes))
    return x[f]


def _set1(x: jax.Array, f, val, axes=None) -> jax.Array:
    """x.at[f].set(val) by global index; local masked where in SPMD mode
    (NO communication — only the owning shard's element changes)."""
    if _data_ax(axes):
        nloc = x.shape[0]
        lo = _shard_lo(nloc, axes)
        return jnp.where(jnp.arange(nloc) + lo == f, val, x)
    return x.at[f].set(val)


def _argmax_n(score: jax.Array, axes=None):
    """(global argmax index, max value) over the (possibly sharded) n axis.

    SPMD: local argmax, then an O(devices) all_gather of (value, global
    index); ``jnp.argmax`` over the gathered values picks the FIRST maximal
    device, which with contiguous row sharding reproduces the single-device
    first-occurrence tie-break exactly."""
    i = jnp.argmax(score)
    v = score[i]
    if _data_ax(axes):
        gi = (_shard_lo(score.shape[0], axes) + i).astype(jnp.int32)
        # one collective phase: the index rides the value exchange as raw
        # bits (XLA's all-gather combiner does not merge mixed-dtype pairs)
        payload = jnp.stack([v.astype(jnp.float32),
                             jax.lax.bitcast_convert_type(gi, jnp.float32)])
        gathered = jax.lax.all_gather(payload, _data_ax(axes))   # (devices, 2)
        k = jnp.argmax(gathered[:, 0])
        f = jax.lax.bitcast_convert_type(gathered[k, 1], jnp.int32)
        return f, gathered[k, 0]
    return i, v


def _any_pos(w: jax.Array, axes=None) -> jax.Array:
    """jnp.any(w > 0) across shards."""
    a = jnp.any(w > 0)
    if _data_ax(axes):
        return jax.lax.psum(a.astype(jnp.int32), _data_ax(axes)) > 0
    return a


def _gather_vec(x: jax.Array, idcs, mask, axes=None) -> jax.Array:
    """x[idcs] (K,) with ~mask zeroed, for a data-sharded (n,)-vector:
    owner-shard local gather + one O(K) psum."""
    if _data_ax(axes):
        nloc = x.shape[0]
        lo = _shard_lo(nloc, axes)
        j = jnp.clip(idcs - lo, 0, nloc - 1)
        mine = mask & (idcs >= lo) & (idcs < lo + nloc)
        return jax.lax.psum(jnp.where(mine, x[j], 0.0), _data_ax(axes))
    return jnp.where(mask, x[idcs], 0.0)


def _scatter_vec(template: jax.Array, idcs, mask, vals, axes=None) -> jax.Array:
    """zeros_like(template) with vals scatter-added at (global) idcs; each
    shard scatters only the entries it owns (NO communication)."""
    if _data_ax(axes):
        nloc = template.shape[0]
        lo = _shard_lo(nloc, axes)
        mine = mask & (idcs >= lo) & (idcs < lo + nloc)
        loc = jnp.where(mine, idcs - lo, 0)
        return jnp.zeros_like(template).at[loc].add(jnp.where(mine, vals, 0.0))
    safe = jnp.where(mask, idcs, 0)
    return jnp.zeros_like(template).at[safe].add(jnp.where(mask, vals, 0.0))


def _gather_rows(consts: SNNLSConsts, idcs, mask, axes=None) -> jax.Array:
    """Rows V[idcs] (K, S) in f32, zeroed where ~mask (dequantized if int8).

    SPMD: each shard extracts the rows it owns locally, one O(K*S) psum
    assembles the block on every device (proj sharding keeps rows as local
    S/dp slices).  This is the OMP / active-set primitive — the gathered
    system is O(K*S), independent of n."""
    if _data_ax(axes):
        nloc = consts.V.shape[0]
        lo = _shard_lo(nloc, axes)
        j = jnp.clip(idcs - lo, 0, nloc - 1)
        mine = mask & (idcs >= lo) & (idcs < lo + nloc)
        rows = consts.V[j]
        if _is_quantized(consts):
            rows = rows.astype(jnp.float32) * (consts.norms[j] * (1.0 / 127.0))[:, None]
        rows = jnp.where(mine[:, None], rows, 0.0).astype(jnp.float32)
        return jax.lax.psum(rows, _data_ax(axes))
    rows = consts.V[idcs]
    if _is_quantized(consts):
        rows = rows.astype(jnp.float32) * (consts.norms[idcs] * (1.0 / 127.0))[:, None]
    return jnp.where(mask[:, None], rows, 0.0)


def _v_matvec(consts: SNNLSConsts, w: jax.Array, support: int = 1024,
              axes=None) -> jax.Array:
    """V^T @ w in f32.

    In int8-resident mode the weight vector's support (w >= 0 always, so the
    nonzeros ARE the top-k) is gathered and only those rows are dequantized:
    O(support*S) work, never an f32 (n, S).  ``support`` must upper-bound
    nnz(w); the build loop ENFORCES nnz(w) <= max_active by refusing any
    step that would select a (max_active+1)-th distinct atom and latching
    ``done`` (see _track_support), so passing support=max_active is always
    exact for solver-produced weights.

    SPMD: a per-shard local contraction + one O(S) psum.  The quantized
    SPMD matvec runs DENSE with on-the-fly dequantization (the convert
    fuses into the dot; no f32 (n, S) materializes) — it runs only at the
    REFRESH_EVERY cadence, so the dense pass is amortized.
    """
    if not _is_quantized(consts):
        return _psum_n(jnp.dot(consts.V.T, w, precision=_GATE,
                               preferred_element_type=jnp.float32), axes)
    if _data_ax(axes):
        wn = w * consts.norms * (1.0 / 127.0)
        return _psum_n(jnp.dot(wn, consts.V.astype(jnp.float32),
                               precision=_GATE,
                               preferred_element_type=jnp.float32), axes)
    k = min(int(support), w.shape[0])
    vals, idx = jax.lax.top_k(w, k)
    rows = consts.V[idx].astype(jnp.float32) * (consts.norms[idx] * (1.0 / 127.0))[:, None]
    return jnp.dot(vals, rows, precision=_GATE,
                   preferred_element_type=jnp.float32)


def init_state(consts: SNNLSConsts, key: jax.Array | None = None,
               max_active: int = 0) -> SNNLSState:
    n, S = consts.V.shape
    # weights/caches stay f32 even when V is the int8-resident copy
    dt = consts.b.dtype if _is_quantized(consts) else consts.V.dtype
    if key is None:
        key = jax.random.key(0)
    # selection counts exist only for the sampling solvers (ps present):
    # a dead (n,) carry would cost an extra read+write pass of the loop
    # state every iteration and 4n bytes of the beyond-HBM budget
    n_cts = n if consts.ps.shape[0] else 0
    return SNNLSState(
        w=jnp.zeros(n, dt),
        xw=jnp.zeros(S, dt),
        cts=jnp.zeros(n_cts, dt),
        idcs=jnp.full((max_active,), -1, jnp.int32),
        size=jnp.int32(0),
        itr=jnp.int32(0),
        fail=jnp.int32(0),
        done=jnp.array(False),
        key=key,
    )


def error_core(consts: SNNLSConsts, w: jax.Array, support: int = 1024,
               axes=None) -> jax.Array:
    xw = _v_matvec(consts, w, support=support, axes=axes)
    return _cached_error(consts, xw, axes=axes)


@partial(jax.jit, static_argnames=("support",))
def error(consts: SNNLSConsts, w: jax.Array, support: int = 1024) -> jax.Array:
    """||A w - b||_2 (snnls/snnls.py:28-29)."""
    return error_core(consts, w, support=support, axes=None)


def _cached_error(consts: SNNLSConsts, xw: jax.Array, axes=None) -> jax.Array:
    return jnp.sqrt(_psum_s(jnp.sum((xw - consts.b) ** 2), axes))


def _safe_div(a, d):
    return a / jnp.where(d == 0, 1.0, d)


def _normalize(x, axes=None):
    n = jnp.sqrt(_psum_s(jnp.sum(x * x), axes))
    n = jnp.where(n == 0, 1.0, n)
    return x / n, n


def _vsel(consts: SNNLSConsts) -> jax.Array:
    """The matrix used for selection: the Vsel copy, or V itself when the
    zero-row sentinel says they coincide (f32 exact mode / int8-resident)."""
    return consts.Vsel if consts.Vsel.shape[0] else consts.V


def _select_dots(consts: SNNLSConsts, dirs, axes=None):
    """An^T @ dirs for every candidate column, via the select-phase copy.

    ``dirs``: (S,) or (S, k) direction(s); entries must be in [-1, 1] for the
    int8 path (callers pass unit vectors / normalized residuals).  Returns
    f32 (n,) or (n, k).

    SPMD: the contraction runs on the local (n/dd, S/dp) shard; with proj
    sharding the per-row partial dots are psum-reduced over the proj axis
    BEFORE normalization.  The sharded path requires the selection copy's
    row/column padding to have been applied before sharding (so local Vsel
    rows align with local V rows — parallel/coreset.py pads to the tile
    multiples up front).
    """
    one_d = dirs.ndim == 1
    d2 = dirs[:, None] if one_d else dirs
    n = consts.V.shape[0]
    Vsel = _vsel(consts)
    Sp = Vsel.shape[1]
    if Sp != d2.shape[0]:                         # padded selection copy
        d2 = jnp.pad(d2, ((0, Sp - d2.shape[0]), (0, 0)))
    if Vsel.dtype == jnp.int8:
        q = jnp.clip(jnp.round(d2 * 127.0), -127, 127).astype(jnp.int8)
        dots = jax.lax.dot_general(Vsel, q, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        # keep the 1/127^2 scale out of the GEMM fusion: when XLA:GPU
        # splits K (seen at 100352 x 512 on an H100), it moves the scaling
        # epilogue ahead of the split-K reduction in int32, truncating the
        # scale to 0 and returning all-zero scores
        dots = jax.lax.optimization_barrier(dots)
        out = _psum_s(dots.astype(jnp.float32)[:n], axes) * (1.0 / (127.0 * 127.0))
    else:
        dots = jnp.dot(Vsel, d2.astype(Vsel.dtype),
                       preferred_element_type=jnp.float32)
        out = _psum_s(dots[:n], axes) / consts.norms[:, None]
    return out[:, 0] if one_d else out


def _track_support(state: SNNLSState, f):
    """Insert f into the active-slot list if new (static-size bookkeeping).

    Every solver tracks its support when slots exist (state.idcs non-empty):
    in int8-resident mode the cached-matvec refresh gathers EXACTLY these
    rows instead of sorting the n-element weight vector.  Slots are capped at
    ``max_active``; selecting MORE distinct atoms than that is a capacity
    overflow, returned as the third element so the build loop can refuse the
    step and latch ``done`` (numeric-limit semantics) — the tracked support,
    and therefore ``error()``/matvec refreshes, must never silently drop a
    live atom (the reference's never-return-wrong-numbers discipline,
    snnls/snnls.py:63-74).
    """
    K = state.idcs.shape[0]
    if K == 0:
        return state.idcs, state.size, jnp.array(False)
    already = jnp.any((state.idcs == f) & (jnp.arange(K) < state.size))
    overflow = ~already & (state.size >= K)
    slot = jnp.minimum(state.size, K - 1)
    idcs = jnp.where(already | overflow, state.idcs, state.idcs.at[slot].set(f))
    size = jnp.where(already | overflow, state.size, state.size + 1)
    return idcs, size, overflow


def _support_matvec(consts: SNNLSConsts, w, idcs, size, axes=None):
    """Exact V^T w via the tracked support (w>0 entries all lie in idcs)."""
    mask = jnp.arange(idcs.shape[0]) < size
    safe = jnp.where(mask, idcs, 0)
    rows = _gather_rows(consts, safe, mask, axes=axes)
    return jnp.dot(_gather_vec(w, safe, mask, axes=axes), rows,
                   precision=_GATE, preferred_element_type=jnp.float32)


def _rank1_update(state: SNNLSState, consts: SNNLSConsts, f, alpha, beta,
                  axes=None):
    """w <- alpha*w; w[f] = max(0, w[f] + beta); update cached xw exactly."""
    old_wf = _get1(state.w, f, axes=axes)
    new_wf = jnp.maximum(0.0, alpha * old_wf + beta)
    w = _set1(alpha * state.w, f, new_wf, axes=axes)
    delta = new_wf - alpha * old_wf
    xw = alpha * state.xw + delta * _v_row(consts, f, axes=axes)
    return w, xw


# ---------------------------------------------------------------------------
# GIGA — greedy iterative geodesic ascent (reference snnls/giga.py:6-64)
# ---------------------------------------------------------------------------

class GigaAux(NamedTuple):
    """Scalar cache carried across GIGA iterations.

    All of the reweight algebra (giga.py:40-64) and the monotonicity check
    reduce to scalar functions of (b.xw, |xw|^2, a few per-atom dots), so
    carrying these between iterations removes nearly every O(S)/O(n)
    reduction from the hot loop — the per-iteration cost collapses to the
    unavoidable select matmul (one streaming pass over V), one row gather,
    one thin (2,S)@(S,) matvec, one exact error reduction, and fused
    elementwise updates.  The cache is recomputed EXACTLY at every
    ``REFRESH_EVERY`` matvec refresh, bounding f32 recursion drift.

    ``wscale``: GIGA's reweight multiplies EVERY weight by alpha each
    iteration (giga.py:61-63) — an O(n) read+write pass per iteration that
    at beyond-cache n costs real HBM bandwidth next to the int8 select
    stream.  The scale is carried here as a scalar instead (true weights
    = wscale * state.w; only the selected index is written per
    iteration), folded back into the weights at every matvec refresh
    trigger below the underflow floor and once when ``build`` returns.
    GIGA and Frank-Wolfe carry it (both rescale globally per iteration);
    the sampling/OMP solvers never touch it (wscale stays 1.0).
    """

    bxw: jax.Array    # b . xw
    nw2: jax.Array    # xw . xw
    err: jax.Array    # ||xw - b||  (exact; carried to avoid the b-scale
    #                   cancellation of err^2 = nw2 - 2 bxw + ||b||^2)
    wscale: jax.Array  # true w = wscale * state.w (GIGA only; 1.0 elsewhere)


_WSCALE_FLOOR = 1e-10   # fold the carried scale into w before it underflows


def _aux_from_xw(consts: SNNLSConsts, xw: jax.Array, axes=None,
                 wscale=1.0) -> GigaAux:
    return GigaAux(_psum_s(jnp.dot(consts.b, xw, precision=_GATE), axes),
                   _psum_s(jnp.dot(xw, xw, precision=_GATE), axes),
                   _cached_error(consts, xw, axes),
                   jnp.asarray(wscale, jnp.float32))


def _giga_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol,
               axes=None):
    bnorm = jnp.where(consts.bnorm == 0, 1.0, consts.bnorm)
    bn = consts.b / bnorm                            # loop-invariant
    nw = jnp.sqrt(jnp.maximum(aux.nw2, 0.0))
    nw_safe = jnp.where(nw == 0, 1.0, nw)            # _normalize semantics
    xwn = state.xw / nw_safe
    bxwn = aux.bxw / (bnorm * nw_safe)               # <bn, xwn>

    # cdir = bn - <bn,xwn> xwn has ||cdir||^2 = 1 - <bn,xwn>^2 exactly
    cdir = bn - bxwn * xwn
    cdirnrm = jnp.sqrt(jnp.maximum(1.0 - bxwn * bxwn, 0.0))
    ok_sel = cdirnrm >= tol                          # giga.py:27-29
    cdirn = cdir / jnp.where(cdirnrm == 0, 1.0, cdirnrm)

    dirs = jnp.stack([cdirn, xwn], axis=1)           # (S, 2), unit columns
    # scores for every candidate: one thin matmul (n,S)@(S,2)
    dots = _select_dots(consts, dirs, axes=axes)      # == An^T [cdir, xw]
    d1 = dots[:, 1]
    geo_ok = (d1 > -1.0 + 1e-14) & (1.0 - d1 * d1 > 0.0)   # giga.py:33
    denom = jnp.sqrt(jnp.clip(1.0 - d1 * d1, 1e-30, None))
    score = jnp.where(geo_ok, dots[:, 0] / denom, 0.0)     # giga.py:34-37
    score = jnp.where(consts.valid, score, _NEG_INF)
    f, _ = _argmax_n(score, axes=axes)

    # reweight (giga.py:40-64): one row gather + one (2,S) matvec + scalars
    xf = _v_row(consts, f, axes=axes)
    nf = _get1(consts.norms, f, axes=axes)
    xfn = xf / nf
    two = _psum_s(jnp.dot(jnp.stack([bn, xwn], axis=0), xfn, precision=_GATE,
                          preferred_element_type=jnp.float32), axes)
    bxf, xwxf = two[0], two[1]                       # <bn,xfn>, <xwn,xfn>
    gA = bxf - bxwn * xwxf
    gB = bxwn - bxf * xwxf
    ok_rw = (gA > 0.0) & (gB >= 0.0)                 # giga.py:50-51

    gsum = jnp.where(gA + gB == 0, 1.0, gA + gB)
    a = gB / gsum / nw_safe
    c = gA / gsum / nf
    # x = a*xw + c*xf never materializes: with xw.xf = nf*nw*<xwn,xfn> and
    # b.xf = bnorm*nf*<bn,xfn>, the optimal scaling (giga.py:56-60)
    # scale = bnorm/||x|| * <x/||x||, bn> = (x.b) / ||x||^2 is all scalars
    xw_xf = nw_safe * nf * xwxf
    b_xf = bnorm * nf * bxf
    nx2 = a * a * aux.nw2 + 2.0 * a * c * xw_xf + c * c * nf * nf
    x_b = a * aux.bxw + c * b_xf
    scale = x_b / jnp.where(nx2 == 0, 1.0, nx2)
    alpha, beta = a * scale, c * scale

    # scale-carried weight update: true w = aux.wscale * state.w, so the
    # global alpha rescale is one scalar multiply and only index f is
    # written — no O(n) pass (the (n,) rescale+commit
    # passes cost real HBM bandwidth at beyond-cache n)
    ws = aux.wscale
    old_raw = _get1(state.w, f, axes=axes)
    old_wf = ws * old_raw
    new_wf = jnp.maximum(0.0, alpha * old_wf + beta)
    delta = new_wf - alpha * old_wf
    xw2 = alpha * state.xw + delta * xf              # xw stays TRUE-scale
    # the cache is recomputed EXACTLY from the new xw (a pure function, so
    # incremental builds track one-shot builds); the measured cost of
    # these O(S) reductions is negligible next to the select matmul
    aux2 = _aux_from_xw(consts, xw2, axes=axes)

    # monotonicity check (reference snnls.py:54-61) folded INTO the step:
    # the commit decision then gates the single-index weight write, so no
    # whole-(n,) candidate/rollback select ever materializes
    if state.idcs.shape[0]:
        size_nonzero = state.size > 0
    else:
        size_nonzero = _any_pos(state.w, axes=axes)
    monotone_ok = ~size_nonzero | (aux2.err <= aux.err * (1.0 + tol))
    ok = ok_sel & ok_rw & monotone_ok & jnp.isfinite(aux2.err)
    idcs2, size2, overflow = _track_support(state, f)
    commit = ok & ~overflow

    aux_out = GigaAux(bxw=jnp.where(commit, aux2.bxw, aux.bxw),
                      nw2=jnp.where(commit, aux2.nw2, aux.nw2),
                      err=jnp.where(commit, aux2.err, aux.err),
                      wscale=aux.wscale)
    return _carried_commit(state, aux_out, f, alpha, ws, old_raw, new_wf,
                           xw2, commit, ok, overflow, idcs2, size2,
                           axes=axes)


def _carried_commit(state, aux_out, f, alpha, ws, old_raw, new_wf, xw2,
                    commit, ok, overflow, idcs2, size2, axes=None):
    """Commit a scale-carried rank-1 weight update: the global alpha
    rescale folds into aux.wscale (scalar), only index f is written, and
    the commit decision gates that single write — no O(n) pass.  The
    scale folds back into the raw weights (one O(n) pass, via lax.cond so
    it only EXECUTES then) when it would underflow — including alpha == 0
    (e.g. a first iteration that zeroes all prior weights)."""
    ws2 = alpha * ws
    fold = ws2 < _WSCALE_FLOOR

    def _fold_write(wr):              # materialize the scale, then write f
        return _set1(wr * ws2, f, new_wf, axes=axes)

    def _raw_write(wr):               # single-index write in raw units
        raw = jnp.where(commit, new_wf / jnp.where(fold, 1.0, ws2), old_raw)
        return _set1(wr, f, raw, axes=axes)

    w2 = jax.lax.cond(fold & commit, _fold_write, _raw_write, state.w)
    ws_out = jnp.where(commit, jnp.where(fold, 1.0, ws2), ws)
    aux_out = aux_out._replace(wscale=ws_out)
    xw_out = jnp.where(commit, xw2, state.xw)
    idcs_out = jnp.where(commit, idcs2, state.idcs)
    size_out = jnp.where(commit, size2, state.size)
    return (w2, xw_out, state.cts, idcs_out, size_out, state.key, ok,
            overflow, aux_out)


# ---------------------------------------------------------------------------
# Frank-Wolfe (reference snnls/frankwolfe.py:5-40)
# ---------------------------------------------------------------------------

def _fw_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol,
             axes=None):
    """Frank-Wolfe step, scale-carried and self-committing like GIGA: the
    per-iteration global rescale w <- (1-gamma) w rides aux.wscale and
    only the selected index is written (no O(n) weight passes)."""
    resid = consts.b - state.xw
    rn, _ = _normalize(resid, axes=axes)  # scale-invariant for the argmax
    dots = _select_dots(consts, rn, axes=axes)
    dots = jnp.where(consts.valid, dots, _NEG_INF)
    f, _ = _argmax_n(dots, axes=axes)

    nsum = _psum_n(jnp.sum(jnp.where(consts.valid, consts.norms, 0.0)), axes)
    nf = _get1(consts.norms, f, axes=axes)
    xf = _v_row(consts, f, axes=axes)
    if state.idcs.shape[0]:
        size_zero = state.size == 0
    else:
        size_zero = ~_any_pos(state.w, axes=axes)

    # line search (frankwolfe.py:26-37)
    dvec = nsum / nf * xf - state.xw
    gammanum = _psum_s(jnp.dot(dvec, resid, precision=_GATE), axes)
    gammadenom = _psum_s(jnp.sum(dvec * dvec), axes)
    ok = (gammanum >= 0.0) & (gammadenom > 0.0) & (gammanum <= gammadenom)
    gamma = _safe_div(gammanum, gammadenom)
    alpha = jnp.where(size_zero, 0.0, 1.0 - gamma)
    beta = jnp.where(size_zero, nsum / nf, nsum / nf * gamma)
    ok = ok | size_zero                              # first-point vertex init

    ws = aux.wscale
    old_raw = _get1(state.w, f, axes=axes)
    old_wf = ws * old_raw
    new_wf = jnp.maximum(0.0, alpha * old_wf + beta)
    delta = new_wf - alpha * old_wf
    xw2 = alpha * state.xw + delta * xf

    # monotonicity check in-step (reference snnls.py:54-61) so the commit
    # gates the single-index write; FW carries no scalar error cache, so
    # both errors are the O(S) cached reductions
    prev_err = _cached_error(consts, state.xw, axes=axes)
    new_err = _cached_error(consts, xw2, axes=axes)
    ok = ok & (size_zero | (new_err <= prev_err * (1.0 + tol)))
    ok = ok & jnp.isfinite(new_err)
    idcs2, size2, overflow = _track_support(state, f)
    commit = ok & ~overflow
    return _carried_commit(state, aux, f, alpha, ws, old_raw, new_wf, xw2,
                           commit, ok, overflow, idcs2, size2, axes=axes)


# ---------------------------------------------------------------------------
# Orthogonal (matching) pursuit (reference snnls/orthopursuit.py:7-42)
# ---------------------------------------------------------------------------

def _omp_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol,
              nnls_iters: int = 256, axes=None):
    resid = consts.b - state.xw
    rn, _ = _normalize(resid, axes=axes)  # scale-invariant: only comparisons matter
    dots = _select_dots(consts, rn, axes=axes)
    pos_dots = jnp.where(consts.valid, dots, _NEG_INF)
    fpos, vpos = _argmax_n(pos_dots, axes=axes)
    active = state.w > 0
    neg_dots = jnp.where(active, -dots, _NEG_INF)
    fneg, vneg = _argmax_n(neg_dots, axes=axes)
    any_active = _any_pos(state.w, axes=axes)
    f = jnp.where(~any_active | (vpos >= vneg), fpos, fneg)

    # append f to active slots if new (static-size bookkeeping)
    idcs, size, overflow = _track_support(state, f)

    # full NNLS on the active set (orthopursuit.py:37-41), small gathered
    # system, warm-started from the current weights (fewer FISTA iterations
    # to re-converge after each single-atom change).  Sharded: the gathered
    # (K, S) block costs one O(K*S) psum, then the solve runs replicated —
    # O(K*S) per iteration, independent of n.
    mask0 = jnp.arange(idcs.shape[0]) < size
    safe_idcs = jnp.where(mask0, idcs, 0)
    x0 = _gather_vec(state.w, safe_idcs, mask0, axes=axes)
    Aact = _gather_rows(consts, safe_idcs, mask0, axes=axes)
    w_act = nnls_rows(Aact, consts.b, mask0, num_iters=nnls_iters, x0=x0)
    w = _scatter_vec(state.w, safe_idcs, mask0, w_act, axes=axes)
    xw = jnp.dot(w_act, Aact, precision=_GATE,   # exact: support == active slots
                 preferred_element_type=jnp.float32)
    return w, xw, state.cts, idcs, size, state.key, jnp.array(True), overflow, aux


# ---------------------------------------------------------------------------
# Importance / uniform sampling (reference snnls/sampling.py:6-37)
# ---------------------------------------------------------------------------

def _sampling_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol,
                   matvec_k: int = 1024, axes=None):
    """One categorical draw (sampling.py:6-37) with an O(S) cache update.

    The weight map w_i = (cts_i / T) / ps_i changes at ONE index per draw up
    to the global rescale T -> T+1, so the cached image updates as
    ``xw <- (T/(T+1)) * xw + V[f] / ((T+1) * ps_f)`` — O(S) instead of the
    reference's O(n*S) per-draw matvec.  The weights themselves are still
    recomputed exactly from the counts (O(n) elementwise, no drift); the
    build loop's periodic exact refresh bounds the f32 drift in xw.

    SPMD: the categorical draw is hierarchical — a replicated draw over the
    per-shard probability masses (from an O(devices) logsumexp exchange)
    picks the owning shard, a second replicated key draws within it —
    which is EXACTLY the target distribution (P(shard) * P(i | shard)),
    but a different random realization than the single-device draw, so
    sharded sampling-solver builds match single-device builds in
    distribution, not bitwise.
    """
    key, sub = jax.random.split(state.key)
    logp = jnp.where(consts.ps > 0, jnp.log(jnp.where(consts.ps > 0, consts.ps, 1.0)),
                     _NEG_INF)
    if _data_ax(axes):
        k_shard, k_in = jax.random.split(sub)
        lse = jax.scipy.special.logsumexp(logp)
        lses = jax.lax.all_gather(lse, _data_ax(axes))        # (devices,)
        shard = jax.random.categorical(k_shard, lses)
        f_loc = jax.random.categorical(k_in, logp)            # same key, local logits
        me = jax.lax.axis_index(_data_ax(axes))
        f = jax.lax.psum(jnp.where(me == shard,
                                   _shard_lo(logp.shape[0], axes) + f_loc, 0),
                         _data_ax(axes))
    else:
        f = jax.random.categorical(sub, logp)
    if state.cts.shape[0] == 0:
        # degenerate problem (no positive sampling mass — init_state elides
        # the counts buffer): every weight stays zero, nothing to track
        return (state.w, state.xw, state.cts, state.idcs, state.size, key,
                jnp.array(True), jnp.array(False), aux)
    cts = _set1(state.cts, f, _get1(state.cts, f, axes=axes) + 1.0, axes=axes)
    T_old = _psum_n(jnp.sum(state.cts), axes)
    T_new = T_old + 1.0
    w = jnp.where(consts.ps > 0, (cts / T_new) / jnp.where(consts.ps > 0, consts.ps, 1.0), 0.0)
    alpha = T_old / T_new
    beta = 1.0 / (T_new * jnp.maximum(_get1(consts.ps, f, axes=axes), 1e-30))
    xw = alpha * state.xw + beta * _v_row(consts, f, axes=axes)
    idcs, size, overflow = _track_support(state, f)
    return w, xw, cts, idcs, size, key, jnp.array(True), overflow, aux


_STEP_FNS = {
    "giga": _giga_step,
    "frankwolfe": _fw_step,
    "orthopursuit": _omp_step,
    "importance": _sampling_step,
    "uniform": _sampling_step,
}
_CHECK_MONOTONE = {
    "giga": True,
    "frankwolfe": True,
    "orthopursuit": True,
    "importance": False,   # sampling.py:16
    "uniform": False,
}


# ---------------------------------------------------------------------------
# Shared greedy build loop (reference snnls/snnls.py:31-79)
# ---------------------------------------------------------------------------

def build_core(consts: SNNLSConsts, state: SNNLSState, itrs, tol,
               method: str = "giga", matvec_k: int = 1024,
               axes=None) -> SNNLSState:
    """Run up to ``itrs`` greedy iterations (continues from current state).

    The un-jitted core: :func:`build` wraps it for single-device use, and
    parallel/coreset.py wraps it in ``jax.shard_map`` for mesh-sharded
    builds with ``axes = (data_axis, proj_axis)`` naming the mesh axes the
    inputs are sharded over.  In that mode per-iteration collectives are
    O(S) psums plus O(devices) argmax exchanges — independent of n, and
    each iteration streams the local V shard exactly once (asserted from
    compiled HLO in tests/test_sharding_hlo.py).  f32 sharded results are
    bit-identical to single-device builds between matvec refreshes (owner
    rows + zero contributions psum to the exact same values); sampling
    solvers match in distribution only (see _sampling_step).

    ``matvec_k`` bounds the weight support for sparse-gather matvecs in
    int8-resident mode (see _v_matvec); ignored for f32 problems.
    """
    if axes is not None and method == "orthopursuit" and _proj_ax(axes):
        raise ValueError("orthopursuit's active-set NNLS needs full-S rows; "
                         "shard the data axis only (shard_proj=False)")
    step_fn = partial(_STEP_FNS[method], axes=axes)
    check_monotone = _CHECK_MONOTONE[method]
    itr_end = state.itr + jnp.asarray(itrs, jnp.int32)

    def cond(carry):
        s, _ = carry
        return (s.itr < itr_end) & ~s.done

    # GIGA and Frank-Wolfe commit inside the step (scale-carried
    # single-index weight write + in-step monotone gate) so the body must
    # not re-apply the O(n) candidate/rollback selects; other solvers keep
    # the generic commit machinery below
    self_commit = method in ("giga", "frankwolfe")

    def body(carry):
        s, aux = carry
        # periodic exact refresh of the cached matvec AND the scalar cache
        # (f32 drift control); when support slots are tracked the exact
        # matvec gathers ONLY those rows (O(K*S)) instead of streaming the
        # full (n, S) V — at beyond-cache n the dense f32 refresh pass
        # costs real amortized bandwidth (2 GB / 64 iterations at N=1M).
        # Sharded builds run the dense per-shard matvec + one O(S) psum
        # instead (a support gather would cost an O(K*S) psum; the dense
        # pass is amortized over REFRESH_EVERY iterations and keeps the
        # build's collectives O(S)); refresh reduction order therefore
        # differs from the single-device build in f32 ulps once a refresh
        # fires (itr >= REFRESH_EVERY).
        if s.idcs.shape[0] and axes is None:
            exact_xw = lambda: _support_matvec(consts, s.w, s.idcs, s.size)
        else:
            exact_xw = lambda: _v_matvec(consts, s.w, support=matvec_k,
                                         axes=axes)
        # state.w is raw-scale for GIGA (true w = aux.wscale * w); the
        # exact image rescales AFTER the matvec (linear), so no O(n) fold
        xw, aux = jax.lax.cond(
            s.itr % REFRESH_EVERY == 0,
            lambda: (lambda x: (x, _aux_from_xw(consts, x, axes=axes,
                                                wscale=aux.wscale)))(
                aux.wscale * exact_xw()),
            lambda: (s.xw, aux))
        s = s._replace(xw=xw)

        w2, xw2, cts2, idcs2, size2, key2, ok, overflow, aux2 = step_fn(
            consts, s, aux, tol)

        if check_monotone and not self_commit:
            size_nonzero = (s.size > 0 if s.idcs.shape[0]
                            else _any_pos(s.w, axes=axes))
            prev_err = _cached_error(consts, s.xw, axes=axes)
            new_err = _cached_error(consts, xw2, axes=axes)
            # fail iff error strictly increased beyond tolerance slack
            # (reference snnls.py:54-61 uses exact >; tol gives f32 headroom)
            monotone_ok = ~size_nonzero | (new_err <= prev_err * (1.0 + tol))
            ok = ok & monotone_ok & jnp.isfinite(new_err)

        fail = jnp.where(ok, 0, s.fail + 1)
        # retry-once-then-latch; a support-capacity overflow latches
        # immediately (the step is refused, never silently mis-tracked)
        done = (fail >= 2) | overflow
        commit = ok & ~overflow

        if self_commit:
            # the step already where-gated everything it returned
            new_s = SNNLSState(w=w2, xw=xw2, cts=cts2, idcs=idcs2,
                               size=size2, itr=s.itr + 1, fail=fail,
                               done=s.done | done, key=key2)
            new_aux = aux2
        else:
            new_s = SNNLSState(
                w=jnp.where(commit, w2, s.w),
                xw=jnp.where(commit, xw2, s.xw),
                cts=jnp.where(commit, cts2, s.cts),
                idcs=jnp.where(commit, idcs2, s.idcs),
                size=jnp.where(commit, size2, s.size),
                itr=s.itr + 1,
                fail=fail,
                done=s.done | done,
                key=key2,
            )
            new_aux = jax.tree_util.tree_map(partial(jnp.where, commit),
                                             aux2, aux)
        return (new_s, new_aux)

    aux0 = _aux_from_xw(consts, state.xw, axes=axes)
    final, final_aux = jax.lax.while_loop(cond, body, (state, aux0))
    if self_commit:
        # fold the carried scale back: callers always see TRUE weights
        final = final._replace(w=final_aux.wscale * final.w)
    return final


@partial(jax.jit, static_argnames=("method", "matvec_k"), donate_argnums=(1,))
def build(consts: SNNLSConsts, state: SNNLSState, itrs, tol, method: str = "giga",
          matvec_k: int = 1024) -> SNNLSState:
    """Jitted single-device build (see :func:`build_core`).  Mesh-sharded
    builds go through parallel/coreset.py's shard_map wrapper instead."""
    return build_core(consts, state, itrs, tol, method=method,
                      matvec_k=matvec_k, axes=None)


def optimize_active_core(consts: SNNLSConsts, state: SNNLSState,
                         idcs: jax.Array, size, tol, num_iters: int = 512,
                         axes=None):
    """Re-solve weights on the current active set (snnls/snnls.py:81-97).

    ``idcs`` are the active column indices (padded, covering ALL w>0
    entries); returns the candidate state and whether it improved the cost
    (caller rolls back otherwise).  Sharded: one O(K*S) active-row psum,
    replicated solve, owner-local scatter (like _omp_step).
    """
    mask = jnp.arange(idcs.shape[0]) < size
    safe_idcs = jnp.where(mask, idcs, 0)
    Aact = _gather_rows(consts, safe_idcs, mask, axes=axes)
    w_act = nnls_rows(Aact, consts.b, mask, num_iters=num_iters)
    w = _scatter_vec(state.w, safe_idcs, mask, w_act, axes=axes)
    xw = jnp.dot(w_act, Aact, precision=_GATE,
                 preferred_element_type=jnp.float32)
    prev_w_act = _gather_vec(state.w, safe_idcs, mask, axes=axes)
    prev_cost = _cached_error(consts, jnp.dot(
        prev_w_act, Aact, precision=_GATE, preferred_element_type=jnp.float32))
    new_cost = _cached_error(consts, xw)
    ok = new_cost <= prev_cost * (1.0 + tol)
    new_state = state._replace(
        w=jnp.where(ok, w, state.w),
        xw=jnp.where(ok, xw, state.xw),
        done=state.done | ~ok,
    )
    return new_state, ok


@jax.jit
def optimize_active(consts: SNNLSConsts, state: SNNLSState, idcs: jax.Array,
                    size, tol, num_iters: int = 512):
    return optimize_active_core(consts, state, idcs, size, tol,
                                num_iters=num_iters, axes=None)


def _active_set_core(state: SNNLSState, axes=None):
    """Tracked-support (indices, weights) — a small fixed-size transfer."""
    K = state.idcs.shape[0]
    mask = jnp.arange(K) < state.size
    safe = jnp.where(mask, state.idcs, 0)
    return (jnp.where(mask, safe, -1),
            _gather_vec(state.w, safe, mask, axes=axes))


@jax.jit
def _active_set(state: SNNLSState):
    return _active_set_core(state, axes=None)


# ---------------------------------------------------------------------------
# Stateful wrappers with the reference's user-facing API
# ---------------------------------------------------------------------------

class SparseNNLS:
    """Stateful facade over the jitted functional core.

    Same API as the reference base class (snnls/snnls.py:8-106):
    ``build(itrs)``, ``optimize()``, ``weights()``, ``error()``, ``size()``,
    ``reset()`` and the ``reached_numeric_limit`` latch.
    """

    method: str = "giga"

    def __init__(self, A, b, valid=None, seed: int = 0, max_active: int | None = None,
                 select_dtype=None):
        A = jnp.asarray(A, config.default_dtype())
        b = jnp.asarray(b, config.default_dtype())
        sampling = self.method if self.method in ("importance", "uniform") else None
        self.consts = make_consts(A, b, valid=valid, sampling=sampling,
                                  select_dtype=select_dtype)
        if self.method in ("giga", "frankwolfe", "orthopursuit"):
            # replicate the reference's zero-column rejection (giga.py:11-13);
            # explicitly-masked (padded) columns are exempt.
            requested = jnp.ones(A.shape[1], bool) if valid is None else jnp.asarray(valid)
            if bool(jnp.any(requested & ~self.consts.valid)):
                raise ValueError(f"{type(self).__name__}: A must not have any 0 columns")
        if self.method == "giga" and float(self.consts.bnorm) == 0.0:
            from ..utils.errors import NumericalPrecisionError
            raise NumericalPrecisionError("norm of b must be > 0")
        n = self.consts.V.shape[0]
        self._max_active = int(max_active) if max_active is not None else min(n, 1024)
        self._seed = seed
        self._mesh = None
        self.state = init_state(self.consts, jax.random.key(seed), self._max_active)

    @classmethod
    def from_consts(cls, consts: SNNLSConsts, seed: int = 0,
                    max_active: int | None = None, mesh=None):
        """Wrap pre-built problem constants (e.g. int8-resident consts from
        :func:`make_consts_quantized` built by a streamed projection) without
        re-materializing A.  Zero columns must already carry valid=False.

        ``mesh``: a ``jax.sharding.Mesh`` — the consts are placed row-sharded
        over its data axis (a no-op for already-sharded buffers, e.g. the
        streamed-sharded HilbertCoreset path) and every operation (build /
        error / optimize / active-set extraction) runs through the shard_map
        SPMD path with O(S) per-iteration collectives.  Row count must be a
        multiple of lcm(1024, mesh data size) (the streamed constructors
        pre-pad to this).
        """
        self = cls.__new__(cls)
        if cls.method == "giga" and float(consts.bnorm) == 0.0:
            from ..utils.errors import NumericalPrecisionError
            raise NumericalPrecisionError("norm of b must be > 0")
        n = consts.V.shape[0]
        self._max_active = int(max_active) if max_active is not None else min(n, 1024)
        self._seed = seed
        self._mesh = mesh
        if mesh is not None:
            from ..parallel.coreset import shard_consts
            from ..parallel.mesh import DATA_AXIS
            ndata = mesh.shape[DATA_AXIS]
            if n % ndata:
                raise ValueError(f"row count {n} must divide the mesh data "
                                 f"axis ({ndata}); pre-pad with valid=False")
            consts = shard_consts(consts, mesh)
        self.consts = consts
        self.state = self._fresh_state()
        return self

    def _fresh_state(self):
        state = init_state(self.consts, jax.random.key(self._seed), self._max_active)
        if self._mesh is not None:
            from ..parallel.coreset import shard_state
            state = shard_state(state, self._mesh)
        return state

    # -- reference API ------------------------------------------------------
    def reset(self):
        self.state = self._fresh_state()

    def save(self, path: str):
        """Checkpoint the solver state (resume with :meth:`restore`)."""
        from ..utils import checkpoint
        checkpoint.save(path, self.state, meta={"method": self.method})

    def restore(self, path: str):
        from ..utils import checkpoint
        self.state, _ = checkpoint.load(path, like=self.state)
        if self._mesh is not None:
            from ..parallel.coreset import shard_state
            self.state = shard_state(self.state, self._mesh)

    def size(self) -> int:
        return int(jnp.sum(self.state.w > 0))

    def weights(self):
        return np.asarray(self.state.w)

    def active(self):
        """(indices, weights) of the active set, device-extracted.

        Transfers O(max_active) scalars instead of the full (n,) weight
        vector — at beyond-HBM n the ``weights()`` pull is the dominant
        host-sync cost of an incremental build.  Valid because the build
        loop enforces nnz(w) <= max_active (see _track_support); rows with
        w == 0 are filtered out.
        """
        if self.state.idcs.shape[0]:
            if self._mesh is not None:
                from ..parallel.coreset import _active_fn
                idx, vals = _active_fn(self._mesh)(self.state)
            else:
                idx, vals = _active_set(self.state)
            idx, vals = np.asarray(idx), np.asarray(vals)
        else:
            vals = np.asarray(self.state.w)
            idx = np.arange(vals.shape[0])
        keep = vals > 0
        return idx[keep], vals[keep]

    def error(self) -> float:
        if self._mesh is not None:
            from ..parallel.coreset import _error_fn
            return float(_error_fn(self._mesh, self._max_active)(
                self.consts, self.state.w))
        return float(error(self.consts, self.state.w, support=self._max_active))

    @property
    def reached_numeric_limit(self) -> bool:
        return bool(self.state.done)

    def build(self, itrs: int, checkpoint_path: str | None = None,
              checkpoint_every: int | None = None):
        """Run ``itrs`` greedy iterations (incremental).

        With ``checkpoint_path``, the state is persisted every
        ``checkpoint_every`` iterations (default: once at the end) and, if a
        checkpoint already exists for a state with MORE progress than the
        current one, it is restored first — crash/preemption recovery for
        long builds (the reference has no equivalent; SURVEY.md §5).
        """
        if self.reached_numeric_limit or self.consts.V.size == 0 or itrs <= 0:
            return
        if checkpoint_path is None:
            self.state = self._run_build(itrs)
            return
        import os
        from ..utils import checkpoint as ckpt
        # the target is relative to the CURRENT state; a checkpoint only
        # fast-forwards progress toward it (never extends the build)
        target = int(self.state.itr) + itrs
        if os.path.exists(checkpoint_path):
            saved, _ = ckpt.load(checkpoint_path, like=self.state)
            if int(saved.itr) > int(self.state.itr):
                self.state = saved
        chunk = checkpoint_every or itrs
        while int(self.state.itr) < target and not self.reached_numeric_limit:
            step = min(chunk, target - int(self.state.itr))
            self.state = self._run_build(step)
            self.save(checkpoint_path)

    def _run_build(self, itrs: int) -> SNNLSState:
        if self._mesh is not None:
            from ..parallel.coreset import _build_fn
            fn = _build_fn(self._mesh, self.method, shard_proj=False,
                           matvec_k=self._max_active)
            return fn(self.consts, self.state, jnp.int32(itrs),
                      jnp.float32(config.TOL))
        return build(self.consts, self.state, itrs, config.TOL,
                     method=self.method, matvec_k=self._max_active)

    def optimize(self, solver: str = "fista"):
        """Re-solve the weights on the active set (snnls/snnls.py:81-97).

        solver="fista": on-chip accelerated projected gradient (default).
        solver="exact": host-side native C++ Lawson-Hanson (exact active-set
        solution, like the reference's scipy nnls call), with the same
        cost-increase rollback + numeric-limit latch.
        """
        if self._mesh is not None:
            # active set via the O(max_active) sharded extraction; the
            # re-solve gathers K rows with one O(K*S) psum inside shard_map
            # (the host-side paths below would all-gather the sharded V)
            if solver == "exact":
                raise ValueError("exact (host C++ Lawson-Hanson) optimize is "
                                 "single-device; mesh-sharded solvers use the "
                                 "on-chip FISTA active-set resolve")
            act, _ = self.active()
            if act.size == 0:
                return
            from ..parallel.coreset import _optimize_fn
            pad = int(2 ** int(np.ceil(np.log2(max(act.size, 8)))))
            idcs = np.zeros(pad, dtype=np.int32)
            idcs[: act.size] = act
            self.state, _ = _optimize_fn(self._mesh, 512)(
                self.consts, self.state, jnp.asarray(idcs),
                jnp.int32(act.size), jnp.float32(config.TOL))
            return
        w = np.asarray(self.state.w)
        act = np.flatnonzero(w > 0)
        if act.size == 0:
            return
        if solver == "exact":
            from .. import native
            # gather ONLY the active rows (in int8-resident mode the full
            # f32 V does not exist and must never be materialized)
            Vact = np.asarray(self.consts.V[jnp.asarray(act)], np.float64)
            if self.consts.V.dtype == jnp.int8:
                Vact = Vact * (np.asarray(self.consts.norms)[act, None] / 127.0)
            b = np.asarray(self.consts.b, np.float64)
            prev_err = self.error()
            x, _ = native.nnls(Vact.T, b)
            w_new = np.zeros_like(w)
            w_new[act] = x.astype(w.dtype)
            cand = self.state._replace(w=jnp.asarray(w_new))
            # same support bound as prev_err = self.error(): a mismatched
            # default here would make the rollback comparison inconsistent
            # for quantized consts with max_active != the default
            new_err = float(error(self.consts, cand.w,
                                  support=max(self._max_active, act.size)))
            if new_err > prev_err * (1.0 + config.TOL):
                self.state = self.state._replace(done=jnp.array(True))
            else:
                self.state = cand
            return
        pad = int(2 ** int(np.ceil(np.log2(max(act.size, 8)))))
        idcs = np.zeros(pad, dtype=np.int32)
        idcs[: act.size] = act
        self.state, _ = optimize_active(
            self.consts, self.state, jnp.asarray(idcs), jnp.int32(act.size), config.TOL
        )


class GIGA(SparseNNLS):
    method = "giga"


class FrankWolfe(SparseNNLS):
    method = "frankwolfe"


class OrthoPursuit(SparseNNLS):
    method = "orthopursuit"


class ImportanceSampling(SparseNNLS):
    method = "importance"


class UniformSampling(SparseNNLS):
    method = "uniform"
