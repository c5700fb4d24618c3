"""Hilbert-norm coresets: projection + sparse NNLS.

Covers the reference's ``bayesiancoresets/coreset/hilbert.py:6-48``:
discretize log-likelihoods into per-datum feature vectors, form the system
A = vecs.T, b = sum of vecs, and delegate to a pluggable snnls solver
(default GIGA).  Weights map back through the (optional) subsample indices.

Departures from the reference:
- the (n, S) projection is one jitted matmul-dominated evaluation;
- the subsample keeps a *static* trace shape: the reference's
  ``np.unique(np.random.randint(...))`` (hilbert.py:16) shrinks the array,
  so here duplicate and zero-vector rows are masked ``valid=False`` (the
  solver can never select them) instead of being physically removed;
- ``stream_chunk_size`` enables beyond-f32-HBM construction: the data is
  projected chunk by chunk, each f32 chunk is quantized ON-CHIP to the
  int8-resident representation (normalized int8 rows + f32 row norms) and
  only that copy is kept, so the peak footprint is N*S bytes + one chunk —
  ~4x the dataset capacity of the default path on the same chip.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.snnls import GIGA, above_norm_floor, make_consts_quantized
from .coreset import Coreset
from .projector import Projector


from ..parallel.streamed import (make_streamed_quantized_consts,
                                 quantize_chunk as _quantize_chunk,
                                 round_up as _round_up)


@partial(jax.jit, donate_argnums=(0,))
def _write_chunk(buf, q, start, bacc, bsum):
    return (jax.lax.dynamic_update_slice(buf, q, (start, 0)), bacc + bsum)


@partial(jax.jit, donate_argnums=(0,))
def _write_rows(buf, q, start):
    """Write an int8 chunk into a (committed, per-device) shard buffer."""
    return jax.lax.dynamic_update_slice(buf, q, (start, 0))


class HilbertCoreset(Coreset):
    def __init__(self, data, ll_projector: Projector, n_subsample: int | None = None,
                 snnls=GIGA, seed: int = 0, max_active: int | None = None,
                 select_dtype=None, stream_chunk_size: int | None = None,
                 mesh=None):
        super().__init__()
        data = np.asarray(data)
        if stream_chunk_size is not None:
            self._init_streamed(data, ll_projector, int(stream_chunk_size),
                                snnls, seed, max_active, n_subsample,
                                mesh=mesh)
            return
        if n_subsample is None:
            sub_idcs = np.arange(data.shape[0])
            vecs = np.asarray(ll_projector.project(data))
            valid = np.ones(data.shape[0], dtype=bool)
        else:
            # match reference sampling distribution (randint-with-replacement
            # then dedup, hilbert.py:16) but keep static shape via masking
            rng = np.random.default_rng(seed)
            sub_idcs = rng.integers(0, data.shape[0], size=n_subsample)
            uniq = np.zeros(n_subsample, dtype=bool)
            uniq[np.unique(sub_idcs, return_index=True)[1]] = True
            vecs = np.asarray(ll_projector.project(data[sub_idcs]))
            valid = uniq
        # mask zero vectors instead of pruning (hilbert.py:20-22), and rows
        # below the float32 floor as candidates (see above_norm_floor)
        norms = np.sqrt((vecs**2).sum(axis=1))
        mean_norm = float(norms[valid].mean())      # over the distinct rows
        valid = valid & (norms > 0.0)
        b = vecs[valid].sum(axis=0)
        valid = valid & above_norm_floor(norms, np.linalg.norm(b), mean_norm)
        if not valid.any():
            raise ValueError("all projected vectors are zero or masked")

        if mesh is not None:
            # in-memory data-parallel path: pad + shard the projected system
            # over the mesh's data axis; the facade then runs every
            # operation through the shard_map SPMD wrappers
            from ..parallel.coreset import make_sharded_consts
            sampling = snnls.method if snnls.method in ("importance", "uniform") else None
            consts, _, _ = make_sharded_consts(
                jnp.asarray(vecs.T), jnp.asarray(b), mesh,
                valid=jnp.asarray(valid), sampling=sampling,
                select_dtype=select_dtype)
            self.snnls = snnls.from_consts(consts, seed=seed,
                                           max_active=max_active, mesh=mesh)
        else:
            self.snnls = snnls(jnp.asarray(vecs.T), jnp.asarray(b),
                               valid=jnp.asarray(valid), seed=seed,
                               max_active=max_active, select_dtype=select_dtype)
        self.sub_idcs = sub_idcs
        self.data = data

    def _init_streamed(self, data, ll_projector, chunk: int, snnls_cls,
                       seed: int, max_active, n_subsample, mesh=None):
        """Chunked projection -> on-chip int8 quantization -> int8-resident
        solver consts.  No f32 (n, S) is materialized on device or host.

        ``mesh``: quantized chunks stream directly into per-device row
        shards (``_init_streamed_sharded``) and the solver runs the
        shard_map SPMD build — the beyond-HBM ceiling scales with the
        device count, with no host- or single-device-resident copy of the
        full matrix ever existing.
        """
        if n_subsample is not None:
            raise ValueError("stream_chunk_size and n_subsample are mutually "
                             "exclusive (subsample the data first instead)")
        if mesh is not None:
            self._init_streamed_sharded(data, ll_projector, chunk, snnls_cls,
                                        seed, max_active, mesh)
            return
        n = data.shape[0]
        n_chunks = -(-n // chunk)

        # streaming chunks are only consistent if the projector holds ONE
        # fixed context across project() calls (true for FamilyProjector /
        # BlackBoxProjector; a custom Projector that resamples inside
        # project() would put chunks in different tangent bases).  Verify by
        # projecting a sentinel row twice before committing to the stream.
        sentinel = jnp.asarray(data[:1])
        p1 = np.asarray(ll_projector.project(sentinel))
        p2 = np.asarray(ll_projector.project(sentinel))
        if not np.array_equal(p1, p2):
            raise ValueError(
                "stream_chunk_size requires a projector with a fixed context "
                "across project() calls; this one returned different vectors "
                "for the same input (does it resample inside project()?)")

        buf = None
        b = None
        norm_chunks = []
        for c in range(n_chunks):
            lo = c * chunk
            live = min(chunk, n - lo)
            xc = np.zeros((chunk,) + data.shape[1:], data.dtype)
            xc[:live] = data[lo:lo + live]
            vecs = ll_projector.project(jnp.asarray(xc))
            if buf is None:
                S = vecs.shape[1]
                # allocate pre-padded (1024-row x 128-column multiples) so
                # make_consts_quantized never has to copy the big buffer
                rows = _round_up(max(n, n_chunks * chunk), 1024)
                Sp = _round_up(S, 128)
                buf = jnp.zeros((rows, Sp), jnp.int8)
                b = jnp.zeros((S,), jnp.float32)
            q, nrm, bsum = _quantize_chunk(vecs, jnp.int32(live))
            buf, b = _write_chunk(buf, q, jnp.int32(lo), b, bsum)
            norm_chunks.append(np.asarray(nrm)[:live])

        norms = np.concatenate(norm_chunks)
        pad = buf.shape[0] - n
        valid = np.pad(above_norm_floor(norms, float(jnp.linalg.norm(b))),
                       (0, pad))
        if not valid.any():
            raise ValueError("all projected vectors are zero or masked")
        sampling = snnls_cls.method if snnls_cls.method in ("importance", "uniform") else None
        consts = make_consts_quantized(
            buf, jnp.asarray(np.pad(norms, (0, pad), constant_values=1.0)),
            jnp.pad(b, (0, buf.shape[1] - b.shape[0])),   # tiny (S,) -> (Sp,)
            valid=jnp.asarray(valid), sampling=sampling)
        self.snnls = snnls_cls.from_consts(consts, seed=seed, max_active=max_active)
        self.sub_idcs = np.arange(n)
        self.data = data

    def _init_streamed_sharded(self, data, ll_projector, chunk: int,
                               snnls_cls, seed: int, max_active, mesh):
        """Streamed construction directly into a row-sharded int8 buffer.

        SPMD projection: every device projects, quantizes, and stores ITS
        OWN rows inside one ``jax.shard_map`` step — the projection phase
        parallelizes over the mesh (it is the dominant construction cost
        at beyond-HBM N), host->device traffic is the raw data rows only
        (not the 4x-larger f32 projection), and no single device or host
        ever holds more than its 1/|mesh| int8 shard plus one f32 chunk.
        The construction itself is parallel/streamed.py
        ``make_streamed_quantized_consts`` (whose multi-controller form
        lets each host pass only its ``streamed_row_layout`` rows);
        the solver then runs the shard_map SPMD build (parallel/coreset.py).
        Projectors whose ``project`` is not jax-traceable (numpy/scipy
        internals) fall back to default-device projection with int8
        shipping (``_init_streamed_sharded_hostproj``).  Reference
        analogue: the N-scaling intent of hilbert.py:16 subsampling,
        replaced by actually scaling N.
        """
        from ..parallel.mesh import DATA_AXIS

        if tuple(mesh.axis_names) != (DATA_AXIS,):
            raise ValueError("streamed-sharded construction takes a 1-D "
                             f"'{DATA_AXIS}' mesh (int8-resident builds are "
                             "data-parallel only)")
        n = data.shape[0]

        # same fixed-context requirement as the single-device stream
        sentinel = jnp.asarray(data[:1])
        p1 = np.asarray(ll_projector.project(sentinel))
        p2 = np.asarray(ll_projector.project(sentinel))
        if not np.array_equal(p1, p2):
            raise ValueError(
                "stream_chunk_size requires a projector with a fixed context "
                "across project() calls; this one returned different vectors "
                "for the same input (does it resample inside project()?)")
        S = p1.shape[1]
        Sp = _round_up(S, 128)

        sampling = snnls_cls.method if snnls_cls.method in ("importance", "uniform") else None
        try:
            consts = make_streamed_quantized_consts(
                data, ll_projector.project, chunk, mesh, n, sampling=sampling,
                S=S)
        except (jax.errors.TracerArrayConversionError,
                jax.errors.TracerBoolConversionError,
                jax.errors.TracerIntegerConversionError,
                jax.errors.ConcretizationTypeError):
            # projector computes outside jax (numpy/scipy internals) —
            # fall back to default-device projection with int8 shipping.
            # The fallback runs OUTSIDE this except block: an in-flight
            # exception pins the failed attempt's traceback, whose frames
            # hold the fully-allocated sharded int8 buffer — calling the
            # fallback here would double peak device memory at exactly
            # the beyond-HBM sizes this path exists for.
            consts = None
        bad = [] if consts is None else [
            p for p in self.spmd_probe(data, ll_projector, consts)
            if not p["ok"]]
        if bad:
            # jax-traceable but NOT shard_map-safe (e.g. normalizes by the
            # batch shape, or closes over a differently-sharded array): the
            # trace-error fallback can't see this, so one probe row per
            # device shard is re-projected on the default device and
            # compared against the committed int8 rows/norms.  The
            # hostproj fallback reproduces the
            # single-device stream's semantics exactly.
            self.log.warning(
                "streamed-sharded SPMD projection disagrees with the "
                "default-device projection on probe rows %s (the projector "
                "is jax-traceable but not shard_map-safe); falling back to "
                "default-device projection with int8 shipping", bad)
            consts = None                 # release the SPMD buffers first
        if consts is None:
            self._init_streamed_sharded_hostproj(
                data, ll_projector, chunk, snnls_cls, seed, max_active,
                mesh, S, Sp)
            return

        self.streamed_sharded_mode = "spmd"
        self.snnls = snnls_cls.from_consts(consts, seed=seed,
                                           max_active=max_active, mesh=mesh)
        self.sub_idcs = np.arange(n)
        self.data = data

    @staticmethod
    def spmd_probe(data, ll_projector, consts, rows=None) -> list[dict]:
        """Probe-row cross-check of the SPMD streamed projection.

        Each probe row is projected on the DEFAULT device (the exact
        computation the single-device stream would run), quantized with the
        same kernel, and compared against the committed sharded int8 row
        and f32 norm.  The SPMD projection compiles into a different
        program (shard_map fusion), so int8 values may differ by +-1 at
        round boundaries and norms by f32 ulps — ``ok`` admits that and
        nothing else.

        ``rows`` defaults to each device shard's first selectable row: a row
        below the norm floor is never a candidate, and its norm is stored
        as 1 (``make_consts_quantized``), so it has no committed norm to
        compare.  Returns one dict per row: the global row, the largest
        int8 difference and both norms.  Costs one tiny projection and an
        O(rows * S) gather; runs once per construction.
        """
        if rows is None:
            rows = []
            for shard in consts.valid.addressable_shards:
                i = int(jnp.argmax(shard.data))          # first selectable row
                if bool(shard.data[i]):
                    rows.append((shard.index[0].start or 0) + i)
        if not len(rows):
            return []
        rows = np.asarray(sorted(rows), np.int64)
        vecs = jnp.asarray(np.asarray(ll_projector.project(jnp.asarray(data[rows]))))
        q_h, nrm_h, _ = _quantize_chunk(vecs, jnp.int32(len(rows)))
        S = q_h.shape[1]
        idx = jnp.asarray(rows)           # buffer row i == global data row i
        q_s = np.asarray(consts.V[idx], np.int32)[:, :S]
        nrm_s = np.asarray(consts.norms[idx])
        nrm_h = np.asarray(nrm_h)
        dq = np.abs(np.asarray(q_h, np.int32) - q_s).max(axis=1)
        rel = np.abs(nrm_h - nrm_s) / np.maximum(np.abs(nrm_h), 1e-30)
        return [{"row": int(r), "int8_max_diff": int(d), "norm_default": float(a),
                 "norm_spmd": float(b), "ok": bool(d <= 1 and e <= 1e-4)}
                for r, d, a, b, e in zip(rows, dq, nrm_h, nrm_s, rel)]

    def _init_streamed_sharded_hostproj(self, data, ll_projector, chunk: int,
                                        snnls_cls, seed: int, max_active,
                                        mesh, S: int, Sp: int):
        """Fallback sharded stream for non-jax-traceable projectors.

        Chunks are projected on the default device; only the quantized
        int8 chunk (4x smaller than the f32 projection) ships to its owner
        device, and the global array is assembled from the per-device
        pieces with ``jax.make_array_from_single_device_arrays``.
        """
        import math

        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        ndata = mesh.shape[DATA_AXIS]
        devs = list(mesh.devices.reshape(-1))
        n = data.shape[0]
        rows_glob = _round_up(n, math.lcm(1024, ndata))
        rows_loc = rows_glob // ndata

        b_total = np.zeros(S, np.float64)
        norms_host = np.zeros(rows_glob, np.float32)
        local_bufs = []
        for k in range(ndata):
            buf_k = jax.device_put(jnp.zeros((rows_loc, Sp), jnp.int8), devs[k])
            shard_lo = k * rows_loc
            shard_n = max(0, min(n - shard_lo, rows_loc))
            for lo in range(0, shard_n, chunk):
                live = min(chunk, shard_n - lo)
                xc = np.zeros((chunk,) + data.shape[1:], data.dtype)
                xc[:live] = data[shard_lo + lo: shard_lo + lo + live]
                vecs = jnp.asarray(np.asarray(ll_projector.project(jnp.asarray(xc))))
                q, nrm, bsum = _quantize_chunk(vecs, jnp.int32(live))
                if q.shape[1] != Sp:
                    q = jnp.pad(q, ((0, 0), (0, Sp - q.shape[1])))
                # ship the int8 chunk (not the f32 projection) to its owner
                buf_k = _write_rows(buf_k, jax.device_put(q, devs[k]),
                                    jnp.int32(lo))
                b_total += np.asarray(bsum, np.float64)
                norms_host[shard_lo + lo: shard_lo + lo + live] = \
                    np.asarray(nrm)[:live]
            local_bufs.append(buf_k)

        Vq = jax.make_array_from_single_device_arrays(
            (rows_glob, Sp), NamedSharding(mesh, P(DATA_AXIS, None)), local_bufs)
        self.streamed_sharded_mode = "hostproj"
        self._finish_streamed_sharded(Vq, norms_host, b_total, data,
                                      snnls_cls, seed, max_active, mesh, S)

    def _finish_streamed_sharded(self, Vq, norms_host, b_total, data,
                                 snnls_cls, seed, max_active, mesh, S: int):
        n = data.shape[0]
        rows_glob, Sp = Vq.shape
        real = np.arange(rows_glob) < n
        valid = real & above_norm_floor(norms_host, np.linalg.norm(b_total),
                                        float(norms_host[real].mean()))
        if not valid.any():
            raise ValueError("all projected vectors are zero or masked")
        sampling = snnls_cls.method if snnls_cls.method in ("importance", "uniform") else None
        consts = make_consts_quantized(
            Vq, jnp.asarray(np.where(real, norms_host, 1.0).astype(np.float32)),
            jnp.asarray(np.pad(b_total.astype(np.float32), (0, Sp - S))),
            valid=jnp.asarray(valid), sampling=sampling)
        self.snnls = snnls_cls.from_consts(consts, seed=seed,
                                           max_active=max_active, mesh=mesh)
        self.sub_idcs = np.arange(n)
        self.data = data

    def reset(self):
        self.snnls.reset()
        super().reset()

    def _sync(self):
        # device-side active-set extraction: transfers O(max_active) values
        # instead of the full (n,) weight vector (the dominant host-sync
        # cost at beyond-HBM n).  Solver rows may be padded beyond the true
        # candidate count (int8-resident tile padding; pads stay at w=0).
        idx, vals = self.snnls.active()
        keep = (idx >= 0) & (idx < len(self.sub_idcs))
        idx, vals = idx[keep], vals[keep]
        order = np.argsort(idx)            # stable order by solver column
        self.wts = vals[order]
        self.idcs = self.sub_idcs[idx[order]]
        self.pts = self.data[self.idcs]
        self.reached_numeric_limit = self.snnls.reached_numeric_limit

    def _build(self, itrs: int):
        self.snnls.build(itrs)
        self._sync()

    def _optimize(self):
        self.snnls.optimize()
        self._sync()

    def error(self) -> float:
        return self.snnls.error()
