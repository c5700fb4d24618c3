"""Mesh-sharded coreset construction.

Data-parallel plan per SURVEY.md §2.5: shard the projection matrix
``V = A.T`` (n, S) across devices along n (optionally across S too); the
per-iteration score matmul and the residual reductions run on the local
shard, and the cross-shard exchanges are EXPLICIT collectives inside
``jax.shard_map``:

- greedy argmax: local argmax + an O(devices) all_gather exchange;
- data-dependent row / scalar reads (``V[f]``, ``w[f]``, ``norms[f]``):
  the owning shard extracts by local ``dynamic_slice``, one O(S) / O(1)
  psum broadcasts it (ops/snnls.py SPMD primitives);
- n- and S-axis reductions: local partials + psum.

Per-device, per-iteration work is therefore ONE streaming pass over the
local V shard — identical per-point cost to the single-device build.  The
earlier GSPMD formulation (one-hot masked reductions, auto-partitioned)
paid a measured ~1.5x per-point inflation because every row read streamed
the full local shard a second time; the shard_map
build is the fix, with the collective volume asserted O(S) and
n-independent from compiled HLO in tests/test_sharding_hlo.py.

The solver state machine itself is unchanged: the same ``ops.snnls``
step functions run inside shard_map with static axis names.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import snnls
from ..utils import config
from .mesh import DATA_AXIS, PROJ_AXIS


def _put(x, sharding: NamedSharding):
    """Place an array on the mesh; works in multi-controller processes too.

    ``jax.device_put`` requires a fully-addressable sharding; when the mesh
    spans processes (DCN, parallel/distributed.py) each controller instead
    contributes its addressable shards of the SPMD-identical host value via
    ``make_array_from_callback``."""
    if getattr(x, "sharding", None) == sharding:
        return x
    if sharding.is_fully_addressable:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(jnp.shape(x), sharding,
                                        lambda idx: x[idx])


def _consts_specs(proj) -> snnls.SNNLSConsts:
    return snnls.SNNLSConsts(
        V=P(DATA_AXIS, proj), b=P(proj), norms=P(DATA_AXIS), bnorm=P(),
        valid=P(DATA_AXIS), ps=P(DATA_AXIS), Vsel=P(DATA_AXIS, proj))


def _state_specs(proj) -> snnls.SNNLSState:
    return snnls.SNNLSState(
        w=P(DATA_AXIS), xw=P(proj), cts=P(DATA_AXIS), idcs=P(), size=P(),
        itr=P(), fail=P(), done=P(), key=P())


def shard_consts(consts: snnls.SNNLSConsts, mesh: Mesh,
                 shard_proj: bool = False) -> snnls.SNNLSConsts:
    """Place solver constants on the mesh: V rows (data) sharded, the rest
    replicated (or V cols sharded too when shard_proj)."""
    proj = PROJ_AXIS if (shard_proj and PROJ_AXIS in mesh.axis_names) else None
    specs = _consts_specs(proj)
    return jax.tree_util.tree_map(
        lambda x, sp: _put(x, NamedSharding(mesh, sp)), consts, specs)


def shard_state(state: snnls.SNNLSState, mesh: Mesh,
                shard_proj: bool = False) -> snnls.SNNLSState:
    proj = PROJ_AXIS if (shard_proj and PROJ_AXIS in mesh.axis_names) else None
    specs = _state_specs(proj)
    return jax.tree_util.tree_map(
        lambda x, sp: _put(x, NamedSharding(mesh, sp)), state, specs)


# jitted shard_map builds, keyed on everything that changes the traced
# program (the jit itself re-specializes on shapes/dtypes)
_BUILD_FNS: dict = {}


def _build_fn(mesh: Mesh, method: str, shard_proj: bool, matvec_k: int):
    proj = PROJ_AXIS if (shard_proj and PROJ_AXIS in mesh.axis_names) else None
    cache_key = (mesh, method, proj, matvec_k)
    fn = _BUILD_FNS.get(cache_key)
    if fn is None:
        core = partial(snnls.build_core, method=method, matvec_k=matvec_k,
                       axes=(DATA_AXIS, proj))
        fn = jax.jit(jax.shard_map(
            core, mesh=mesh,
            in_specs=(_consts_specs(proj), _state_specs(proj), P(), P()),
            out_specs=_state_specs(proj), check_vma=False))
        _BUILD_FNS[cache_key] = fn
    return fn


def _active_fn(mesh: Mesh):
    """shard_map'd tracked-support extraction (O(max_active) transfer)."""
    key = (mesh, "active")
    fn = _BUILD_FNS.get(key)
    if fn is None:
        core = partial(snnls._active_set_core, axes=(DATA_AXIS, None))
        fn = jax.jit(jax.shard_map(core, mesh=mesh,
                                   in_specs=(_state_specs(None),),
                                   out_specs=(P(), P()), check_vma=False))
        _BUILD_FNS[key] = fn
    return fn


def _error_fn(mesh: Mesh, support: int):
    key = (mesh, "error", support)
    fn = _BUILD_FNS.get(key)
    if fn is None:
        core = partial(snnls.error_core, support=support,
                       axes=(DATA_AXIS, None))
        fn = jax.jit(jax.shard_map(core, mesh=mesh,
                                   in_specs=(_consts_specs(None), P(DATA_AXIS)),
                                   out_specs=P(), check_vma=False))
        _BUILD_FNS[key] = fn
    return fn


def _optimize_fn(mesh: Mesh, num_iters: int):
    key = (mesh, "optimize", num_iters)
    fn = _BUILD_FNS.get(key)
    if fn is None:
        core = partial(snnls.optimize_active_core, num_iters=num_iters,
                       axes=(DATA_AXIS, None))
        fn = jax.jit(jax.shard_map(
            core, mesh=mesh,
            in_specs=(_consts_specs(None), _state_specs(None), P(), P(), P()),
            out_specs=(_state_specs(None), P()), check_vma=False))
        _BUILD_FNS[key] = fn
    return fn


def _pad_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def make_sharded_consts(A, b, mesh: Mesh, valid=None, sampling=None,
                        select_dtype=None, shard_proj: bool = False):
    """Pad + build + shard solver constants for a mesh-sharded problem.

    Inputs are zero-padded (with ``valid=False`` on padded columns) so the
    data axis divides the mesh's data dimension — and, when a
    reduced-precision selection copy is requested, so the 1024-row padding
    ``make_consts`` applies lands on shard boundaries (local Vsel rows must
    align with local V rows).  Returns (consts, n_orig, S_orig).
    """
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    S, n = A.shape
    ndata = mesh.shape[DATA_AXIS]
    nproj = mesh.shape.get(PROJ_AXIS, 1) if shard_proj else 1
    row_mult = math.lcm(ndata, 1024) if select_dtype is not None else ndata
    # S is padded ONLY under proj sharding: a padded S changes the f32
    # reduction grouping of the reweight dots (ulp drift vs the
    # single-device build, enough to flip near-tie selections); Vsel's own
    # lane padding is internal to make_consts and column-local, so
    # data-only meshes keep V/b at the caller's S and stay bit-exact
    if nproj > 1:
        col_mult = math.lcm(nproj, 128) if select_dtype is not None else nproj
    else:
        col_mult = 1
    n_pad = _pad_multiple(n, row_mult)
    S_pad = _pad_multiple(S, col_mult)
    if valid is None:
        valid = jnp.ones(n, dtype=bool)
    else:
        valid = jnp.asarray(valid)
    if (n_pad, S_pad) != (n, S):
        A = jnp.pad(A, ((0, S_pad - S), (0, n_pad - n)))
        b = jnp.pad(b, (0, S_pad - S))
        valid = jnp.pad(valid, (0, n_pad - n))
    consts = snnls.make_consts(A, b, valid=valid, sampling=sampling,
                               select_dtype=select_dtype)
    return shard_consts(consts, mesh, shard_proj), n, S


def build_sharded(A, b, itrs: int, mesh: Mesh, method: str = "giga",
                  valid=None, key=None, shard_proj: bool = False,
                  max_active: int = 0, select_dtype=None) -> snnls.SNNLSState:
    """Run a mesh-sharded snnls build; returns the final (sharded) state,
    trimmed back to the caller's n (see make_sharded_consts for padding)."""
    sampling = method if method in ("importance", "uniform") else None
    consts, n, S = make_sharded_consts(A, b, mesh, valid=valid,
                                       sampling=sampling,
                                       select_dtype=select_dtype,
                                       shard_proj=shard_proj)
    state = snnls.init_state(consts, key, max_active=max_active)
    state = shard_state(state, mesh, shard_proj)
    fn = _build_fn(mesh, method, shard_proj, matvec_k=max_active or 1024)
    state = fn(consts, state, jnp.int32(itrs), jnp.float32(config.TOL))
    if consts.V.shape[0] != n:
        state = state._replace(w=state.w[:n], cts=state.cts[:n])
    if state.xw.shape[0] != S:
        state = state._replace(xw=state.xw[:S])
    return state


def build_sharded_quantized(Vq, norms, b, itrs: int, mesh: Mesh,
                            method: str = "giga", valid=None, key=None,
                            max_active: int = 1024) -> snnls.SNNLSState:
    """Sharded build over int8-RESIDENT constants (beyond-HBM x DP).

    Composes `make_consts_quantized` with row sharding: each device holds
    1/|mesh| of the int8 copy, so the mesh scales the single-device
    beyond-HBM ceiling by the device count.  Rows are padded to a
    shard-aligned multiple of 1024 up front
    (see build_sharded); at beyond-HBM scale allocate the buffer
    pre-padded per device (coresets/hilbert.py streamed construction +
    make_sharded_quantized_consts) so no host-side full copy exists.
    """
    sampling = method if method in ("importance", "uniform") else None
    Vq = jnp.asarray(Vq)
    n = Vq.shape[0]
    ndata = mesh.shape[DATA_AXIS]
    row_mult = math.lcm(ndata, 1024)
    n_pad = _pad_multiple(n, row_mult)
    norms = jnp.asarray(norms, jnp.float32)
    if valid is None:
        valid = jnp.ones(n, dtype=bool)
    else:
        valid = jnp.asarray(valid)
    if n_pad != n:
        Vq = jnp.pad(Vq, ((0, n_pad - n), (0, 0)))
        norms = jnp.pad(norms, (0, n_pad - n), constant_values=1.0)
        valid = jnp.pad(valid, (0, n_pad - n), constant_values=False)
    consts = snnls.make_consts_quantized(Vq, norms, jnp.asarray(b),
                                         valid=valid, sampling=sampling)
    consts = shard_consts(consts, mesh, shard_proj=False)
    state = snnls.init_state(consts, key, max_active=max_active)
    state = shard_state(state, mesh, shard_proj=False)
    fn = _build_fn(mesh, method, shard_proj=False, matvec_k=max_active)
    state = fn(consts, state, jnp.int32(itrs), jnp.float32(config.TOL))
    if n_pad != n:
        state = state._replace(w=state.w[:n], cts=state.cts[:n])
    return state
