"""Streamed int8-resident sharded construction (single- AND multi-controller).

The beyond-HBM construction path: raw data rows are projected chunk by
chunk, quantized ON-CHIP to the int8-resident representation (normalized
int8 rows + f32 norms, ops/snnls.py make_consts_quantized invariants), and
written directly into each device's row shard — no host or device ever
holds more than its 1/|mesh| int8 shard plus one f32 projection chunk, so
the capacity ceiling scales with the device count.  Projection runs
INSIDE one ``jax.shard_map`` step, so the construction phase parallelizes
with the mesh too (per-device step work is flat in the mesh size,
tests/test_sharding_hlo.py).

Multi-controller (multi-host) deployments call :func:`streamed_row_layout` to
learn which global rows THIS process must load, then
:func:`make_streamed_quantized_consts` with only those rows; all
processes participate in the same SPMD steps (jax.distributed must be
initialized, parallel/distributed.py).  Single-controller callers pass the
full dataset (``HilbertCoreset(stream_chunk_size=..., mesh=...)`` does
this, coresets/hilbert.py).

Reference analogue: the N-scaling intent of the reference's subsampling
(bayesiancoresets/coreset/hilbert.py:16), replaced by actually scaling N
over the mesh.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import snnls
from .mesh import DATA_AXIS


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.jit
def quantize_chunk(vecs, live):
    """f32 (C, S) projection chunk -> (int8 normalized rows, norms, b part).

    Rows at positions >= ``live`` are zeroed (padding).  Module-level jit
    so every streamed constructor with the same chunk shape shares one
    compilation.
    """
    rowmask = jnp.arange(vecs.shape[0]) < live
    vecs = jnp.where(rowmask[:, None], vecs, 0.0)
    nrm = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
    safe = jnp.where(nrm > 0, nrm, 1.0)
    q = jnp.clip(jnp.round(vecs / safe[:, None] * 127.0), -127, 127).astype(jnp.int8)
    return q, nrm, jnp.sum(vecs, axis=0)


def make_sharded_stream_step(project_fn, mesh, Sp: int, extra_dims: int = 1):
    """One SPMD streamed-construction step over the mesh's data axis.

    Every device projects its own (csize, ...) raw-data chunk with
    ``project_fn``, quantizes it to the int8-resident representation, and
    writes it into its local slice of the row-sharded buffer; the only
    collective is ONE O(S) psum of the b partial sums.  Module-level so
    the scaling harness / HLO tests can cost-analyze the EXACT program
    ``HilbertCoreset(stream_chunk_size=..., mesh=...)`` runs.

    Returns ``step(buf, xc, live, lo) -> (buf, norms, bsum)`` (jitted,
    buf donated): ``buf`` (rows_glob, Sp) int8 sharded P(data, None);
    ``xc`` (ndata*csize, ...) rows sharded P(data); ``live`` (ndata,)
    int32 sharded; ``lo`` replicated scalar write offset.
    """
    extra = (None,) * extra_dims

    def core(buf_loc, xc_loc, live_loc, lo):
        vecs = project_fn(xc_loc)                     # on-shard
        q, nrm, bsum = quantize_chunk(vecs, live_loc[0])
        if q.shape[1] != Sp:
            q = jnp.pad(q, ((0, 0), (0, Sp - q.shape[1])))
        buf_loc = jax.lax.dynamic_update_slice(buf_loc, q, (lo, 0))
        return buf_loc, nrm, jax.lax.psum(bsum, DATA_AXIS)

    return jax.jit(jax.shard_map(
        core, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, *extra),
                  P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P())),
        donate_argnums=0)


def streamed_row_layout(n: int, mesh):
    """Row layout of the streamed-sharded int8 buffer.

    Returns ``(rows_glob, rows_loc, positions, local_rows)``:
    ``rows_glob`` padded global row count (1024-tile x mesh multiple),
    ``rows_loc`` rows per device, ``positions`` this process's device
    positions along the mesh's flattened data axis, and ``local_rows``
    the slice of [0, n) THIS process must pass to
    :func:`make_streamed_quantized_consts` (global data row i lives at
    buffer row i; device k owns buffer rows [k*rows_loc, (k+1)*rows_loc)).
    """
    ndata = mesh.shape[DATA_AXIS]
    rows_glob = round_up(n, math.lcm(1024, ndata))
    rows_loc = rows_glob // ndata
    flat = list(mesh.devices.reshape(-1))
    pos = [i for i, d in enumerate(flat)
           if d.process_index == jax.process_index()]
    if not pos:                         # process not in this mesh: no rows
        return rows_glob, rows_loc, [], slice(0, 0)
    if pos != list(range(pos[0], pos[0] + len(pos))):
        raise ValueError(
            "this process's devices are not contiguous along the data axis; "
            "build the mesh so each process owns a contiguous device block")
    lo = min(pos[0] * rows_loc, n)
    hi = min((pos[-1] + 1) * rows_loc, n)
    return rows_glob, rows_loc, pos, slice(lo, hi)


def make_streamed_quantized_consts(local_rows, project_fn, chunk: int, mesh,
                                   n: int, sampling: str | None = None,
                                   S: int | None = None):
    """Stream-construct int8-resident sharded solver constants.

    ``local_rows``: the data rows THIS process owns — exactly
    ``streamed_row_layout(n, mesh).local_rows`` (single-controller: the
    whole dataset).  ``project_fn(pts) -> (C, S) f32`` must be
    jax-traceable (it compiles INTO the per-shard SPMD step); a
    non-traceable projector raises at trace time
    (jax.errors.TracerArrayConversionError and friends — the
    single-controller HilbertCoreset facade catches these and falls back
    to default-device projection).

    ``S``: the projection dimension, if the caller already knows it —
    otherwise one tiny probe projection is run to read it.

    All processes must call this (and the subsequent solver operations)
    collectively.  Returns :class:`~..ops.snnls.SNNLSConsts` with the int8
    matrix row-sharded over the mesh, ready for
    ``SparseNNLS.from_consts(consts, mesh=mesh)`` /
    ``parallel.coreset._build_fn``.
    """
    local_rows = np.asarray(local_rows)
    rows_glob, rows_loc, pos, sl = streamed_row_layout(n, mesh)
    if local_rows.shape[0] != sl.stop - sl.start:
        raise ValueError(
            f"local_rows has {local_rows.shape[0]} rows; this process owns "
            f"rows [{sl.start}, {sl.stop}) — use streamed_row_layout")
    flat = list(mesh.devices.reshape(-1))
    extra_shape = local_rows.shape[1:]

    if S is None:
        # probe the projection dimension (one tiny local projection)
        probe_in = (local_rows[:1] if local_rows.shape[0] else
                    np.zeros((1,) + extra_shape, local_rows.dtype))
        S = int(np.asarray(project_fn(jnp.asarray(probe_in))).shape[1])
    Sp = round_up(S, 128)

    buf_sh = NamedSharding(mesh, P(DATA_AXIS, None))
    row_sh = NamedSharding(mesh, P(DATA_AXIS, *([None] * len(extra_shape))))
    live_sh = NamedSharding(mesh, P(DATA_AXIS))
    buf = jax.jit(lambda: jnp.zeros((rows_glob, Sp), jnp.int8),
                  out_shardings=buf_sh)()
    step = make_sharded_stream_step(project_fn, mesh, Sp,
                                    extra_dims=len(extra_shape))
    ndata = mesh.shape[DATA_AXIS]
    base = (pos[0] if pos else 0) * rows_loc   # global row of local row 0

    norms_local = np.zeros(len(pos) * rows_loc, np.float32)
    b_total = np.zeros(S, np.float64)

    def _one_step(buf, lo: int, csize: int):
        # per-local-device chunk pieces; remote processes supply theirs
        px, pl = [], []
        for k in pos:
            g0 = k * rows_loc + lo
            cnt = max(0, min(n - g0, csize))
            xc = np.zeros((csize,) + extra_shape, local_rows.dtype)
            if cnt:
                xc[:cnt] = local_rows[g0 - base: g0 - base + cnt]
            px.append(jax.device_put(jnp.asarray(xc), flat[k]))
            pl.append(jax.device_put(jnp.asarray(np.full(1, cnt, np.int32)),
                                     flat[k]))
        xg = jax.make_array_from_single_device_arrays(
            (ndata * csize,) + extra_shape, row_sh, px)
        lg = jax.make_array_from_single_device_arrays((ndata,), live_sh, pl)
        buf, nrm, bsum = step(buf, xg, lg, jnp.int32(lo))
        for shard in nrm.addressable_shards:
            # device position (index[0].start is None on a 1-device mesh:
            # the axis is unsharded and the slice is slice(None))
            k = (shard.index[0].start or 0) // csize
            off = (k - pos[0]) * rows_loc + lo
            norms_local[off: off + csize] = np.asarray(shard.data)
        b_total[:] += np.asarray(bsum, np.float64)
        return buf

    # full steps of one static shape, then one (differently-shaped,
    # compiled-once) tail step — every write is a whole block, so no row
    # is quantized or accumulated into b twice
    chunk2 = min(chunk, rows_loc)
    full_steps = list(range(0, rows_loc - chunk2 + 1, chunk2))
    tail_lo = full_steps[-1] + chunk2
    tail = rows_loc - tail_lo
    for lo in full_steps:
        buf = _one_step(buf, lo, chunk2)
    if tail > 0:
        buf = _one_step(buf, tail_lo, tail)

    # per-segment host fixups (make_consts_quantized invariants), then the
    # global (rows_glob,) arrays are assembled from per-device pieces —
    # multi-controller safe (each process contributes only its shards)
    gidx_all = np.arange(len(pos) * rows_loc) + base
    real = gidx_all < n

    def _global_sum(loc):
        # one tiny cross-process allgather when distributed
        loc = np.asarray(loc, np.float64)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(loc)).sum(axis=0)
        return loc

    # b_total is already global (the step psums it over the mesh); the
    # floor's mean row norm is taken over every process's real rows
    n_real, real_sum = _global_sum([real.sum(),
                                    (norms_local * real).sum(dtype=np.float64)])
    valid_local = real & snnls.above_norm_floor(
        norms_local, np.linalg.norm(b_total), real_sum / max(n_real, 1.0))
    norms_fixed = np.where(valid_local, norms_local, 1.0).astype(np.float32)

    def _global_1d(vals, dtype):
        pieces = [jax.device_put(
            jnp.asarray(vals[(k - pos[0]) * rows_loc:
                             (k - pos[0] + 1) * rows_loc].astype(dtype)),
            flat[k]) for k in pos]
        return jax.make_array_from_single_device_arrays(
            (rows_glob,), live_sh, pieces)

    norms_g = _global_1d(norms_fixed, np.float32)
    valid_g = _global_1d(valid_local, bool)

    # global scalar reductions for sampling probabilities and the
    # all-invalid guard
    n_valid, norm_sum = _global_sum([valid_local.sum(),
                                     (norms_local * valid_local).sum()])
    if n_valid == 0:
        raise ValueError("all projected vectors are zero or masked")
    b = np.pad(b_total.astype(np.float32), (0, Sp - S))
    # f32, same op as ops.snnls._finish_quantized — an f64 host bnorm would
    # differ by ulps and shift GIGA's scalar algebra measurably over a build
    bnorm = jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(b))))

    if sampling == "importance":
        ps_local = np.where(
            valid_local,
            norms_fixed / norm_sum if norm_sum > 0 else 1.0 / n_valid,
            0.0)
        ps = _global_1d(ps_local, np.float32)
    elif sampling == "uniform":
        ps = _global_1d(np.where(valid_local, 1.0 / n_valid, 0.0), np.float32)
    else:
        ps = jnp.zeros(0, jnp.float32)       # non-sampling marker

    return snnls.SNNLSConsts(
        V=buf, b=jnp.asarray(b), norms=norms_g, bnorm=bnorm,
        valid=valid_g, ps=ps, Vsel=jnp.zeros((0, Sp), jnp.int8))


def lower_stream_step_for_analysis(mesh, csize: int, S: int, d: int):
    """Lower ONE SPMD stream step on a synthetic logistic projector and
    return the compiled executable — the program HilbertCoreset runs, for
    the HLO communication test (tests/test_sharding_hlo.py)."""
    from ..coresets.projector import center_lls
    from ..models import logistic

    ndev = mesh.shape[DATA_AXIS]
    Sp = round_up(S, 128)
    ths = 0.1 * jax.random.normal(jax.random.key(0), (S, d), jnp.float32)
    project = lambda pts: center_lls(logistic.log_likelihood(pts, ths))
    step = make_sharded_stream_step(project, mesh, Sp, extra_dims=1)
    rows_loc = round_up(4 * csize, 1024)
    buf = jax.device_put(jnp.zeros((ndev * rows_loc, Sp), jnp.int8),
                         NamedSharding(mesh, P(DATA_AXIS, None)))
    xc = jax.device_put(jnp.zeros((ndev * csize, d), jnp.float32),
                        NamedSharding(mesh, P(DATA_AXIS, None)))
    live = jax.device_put(jnp.full(ndev, csize, jnp.int32),
                          NamedSharding(mesh, P(DATA_AXIS)))
    return step.lower(buf, xc, live, jnp.int32(0)).compile()
