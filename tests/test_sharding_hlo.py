"""Compiled-HLO assertions on the sharded build's communication volume.

The scaling claim behind the data-parallel design (SURVEY.md §2.5: per-shard
partials + psum-reduced residual statistics) is only real if the sharded
program (a) keeps V = A.T (n, S) partitioned and (b) streams the local V
shard exactly once per iteration.  The shard_map build (parallel/coreset.py)
makes every cross-shard exchange an explicit collective, so the compiled
HLO can be audited directly:

1. no collective's result touches an n-scale operand (V or an (n,) vector);
2. total collective bytes are IDENTICAL when n doubles (n-independence);
3. the detector itself is validated against the known-bad pattern (the
   plain jitted build GSPMD-partitioned over sharded inputs resolves its
   dynamic row gathers by ALL-GATHERING V).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_coresets_tpu.ops import snnls
from bayesian_coresets_tpu.parallel import make_mesh
from bayesian_coresets_tpu.parallel.coreset import (_build_fn, shard_consts,
                                                    shard_state)
from bayesian_coresets_tpu.utils import config
from bayesian_coresets_tpu.utils.hlo import collective_stats


def _make_problem(n, S, quantized):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(S, n)).astype(np.float32)
    b = A.sum(axis=1)
    if quantized:
        V = A.T
        norms = np.sqrt((V**2).sum(axis=1)).astype(np.float32)
        Vq = np.clip(np.round(V / norms[:, None] * 127.0), -127, 127).astype(np.int8)
        consts = snnls.make_consts_quantized(jnp.asarray(Vq), jnp.asarray(norms),
                                             jnp.asarray(b))
        return consts, dict(matvec_k=256)
    return snnls.make_consts(jnp.asarray(A), jnp.asarray(b)), {}


def _compiled_build_hlo(n, S, mesh, quantized=False, method="giga", itrs=50):
    consts, kw = _make_problem(n, S, quantized)
    consts = shard_consts(consts, mesh)
    state = snnls.init_state(consts, max_active=256)
    state = shard_state(state, mesh)
    fn = _build_fn(mesh, method, shard_proj=False,
                   matvec_k=kw.get("matvec_k", 1024))
    return fn.lower(consts, state, jnp.int32(itrs),
                    jnp.float32(config.TOL)).compile().as_text()


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32", "int8_resident"])
def test_v_stays_partitioned_and_collectives_are_n_independent(
        cpu_devices, quantized):
    S, n1, n2 = 32, 2048, 4096
    mesh = make_mesh({"data": 8})
    ndev = 8

    stats1 = collective_stats(_compiled_build_hlo(n1, S, mesh, quantized))
    stats2 = collective_stats(_compiled_build_hlo(n2, S, mesh, quantized))

    # (1) no collective result at n scale: the largest legitimate collective
    # is an O(S) all-reduce (row extraction / refresh matvec; S is padded to
    # the 128 lane multiple in quantized mode) or the O(devices) argmax
    # exchange — far below even one shard of V or an (n,) vector.
    Sp = 128 if quantized else S
    cap = 4 * (Sp + ndev) * 4         # bytes; generous headroom over O(S)
    for op, nbytes, line in stats1 + stats2:
        assert nbytes <= cap, (
            f"collective touches an n-scale operand ({nbytes} bytes > cap "
            f"{cap}): the sharded build is replicating data\n{line[:200]}")
        assert nbytes < n1 * 4, line[:200]

    # (2) communication volume must not change when n doubles
    sig1 = sorted((op, nbytes) for op, nbytes, _ in stats1)
    sig2 = sorted((op, nbytes) for op, nbytes, _ in stats2)
    assert sig1 == sig2, (
        f"per-iteration collective bytes depend on n:\n{sig1}\nvs\n{sig2}")

    # the loop does communicate (this is a real multi-device program)
    assert any(op == "all-reduce" for op, _, _ in stats1)


def test_omp_sharded_collectives_are_n_independent(cpu_devices):
    """OrthoPursuit's per-iteration active-set gather is O(K*S) — legal, but
    it must stay independent of n."""
    S, n1, n2, K = 32, 2048, 4096, 256
    mesh = make_mesh({"data": 8})
    stats1 = collective_stats(
        _compiled_build_hlo(n1, S, mesh, method="orthopursuit"))
    stats2 = collective_stats(
        _compiled_build_hlo(n2, S, mesh, method="orthopursuit"))
    # the (K, S) active-row psum dominates and legitimately exceeds O(n)
    # at this toy n — n-INDEPENDENCE (below) is the scaling guarantee
    cap = 2 * K * S * 4
    for op, nbytes, line in stats1 + stats2:
        assert nbytes <= cap, line[:200]
    sig1 = sorted((op, nbytes) for op, nbytes, _ in stats1)
    sig2 = sorted((op, nbytes) for op, nbytes, _ in stats2)
    assert sig1 == sig2


def _svi_compiled(n, n_sub, mesh, d=8, cap_slots=16, itrs=4):
    import bayesian_coresets_tpu  # noqa: F401 (register families)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bayesian_coresets_tpu.coresets import gaussian_tangent_family
    from bayesian_coresets_tpu.coresets.sparsevi import svi_build
    from bayesian_coresets_tpu.models import gaussian

    fam = gaussian_tangent_family(jnp.zeros(d), jnp.eye(d), jnp.eye(d), jnp.eye(d))
    x = gaussian.gen_synthetic(jax.random.key(1), n, d)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    wts = jnp.zeros(cap_slots)
    idcs = jnp.full(cap_slots, -1, jnp.int32)
    sched = lambda i: 1.0 / (1.0 + i)
    return svi_build.lower(
        xs, wts, idcs, jnp.int32(0), jax.random.key(0), jnp.int32(itrs),
        family=fam, n_sub_sel=n_sub, n_sub_opt=n_sub, opt_itrs=10,
        step_sched=sched).compile()


def _svi_hlo(n, n_sub, mesh, d=8, cap_slots=16, itrs=4):
    return _svi_compiled(n, n_sub, mesh, d, cap_slots, itrs).as_text()


def _bpsvi_compiled(n, n_sub, mesh, d=8, sz=8):
    import bayesian_coresets_tpu  # noqa: F401
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bayesian_coresets_tpu.coresets import gaussian_tangent_family
    from bayesian_coresets_tpu.coresets.bpsvi import (bpsvi_build,
                                                      uniform_init_idcs)
    from bayesian_coresets_tpu.models import gaussian

    fam = gaussian_tangent_family(jnp.zeros(d), jnp.eye(d), jnp.eye(d), jnp.eye(d))
    x = gaussian.gen_synthetic(jax.random.key(1), n, d)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    init = uniform_init_idcs(n, sz, jax.random.key(2))
    sched = lambda i: 1.0 / (1.0 + i)
    return bpsvi_build.lower(
        xs, init, jax.random.key(0), family=fam, n_sub_opt=n_sub,
        opt_itrs=10, step_sched=sched).compile()


def _bpsvi_hlo(n, n_sub, mesh, d=8, sz=8):
    return _bpsvi_compiled(n, n_sub, mesh, d, sz).as_text()


@pytest.mark.parametrize("n_sub", [None, 256], ids=["full", "subsampled"])
@pytest.mark.parametrize("kind", ["svi", "bpsvi"])
def test_svi_bpsvi_sharded_collectives_are_n_independent(cpu_devices, kind,
                                                         n_sub):
    """SparseVI/BPSVI sharded builds (plain jit over row-sharded data): the
    GSPMD partitioner must resolve the coreset-point and subsample gathers
    as partial-gather + O(gather_size*d) psum — NOT by all-gathering the
    (n, d) data.  Collective bytes must be capped
    at the subsample/coreset scale and identical when n doubles."""
    d, n1, n2 = 8, 4096, 8192
    mesh = make_mesh({"data": 8})
    fn = _svi_hlo if kind == "svi" else _bpsvi_hlo
    stats1 = collective_stats(fn(n1, n_sub, mesh))
    stats2 = collective_stats(fn(n2, n_sub, mesh))

    # cap: the subsample-gather psum ((n_sub, d) f32) dominates; everything
    # else is O(S) residual reductions / O(M*d) coreset-point gathers
    cap = 4 * ((n_sub or 0) * d + 512 + 64 * d) * 4
    for op, nbytes, line in stats1 + stats2:
        assert nbytes <= cap, (
            f"{kind} collective at n scale ({nbytes} bytes > cap {cap}): "
            f"GSPMD is replicating the sharded data\n{line[:200]}")
        assert nbytes < n1 * d * 4, line[:200]

    sig1 = sorted((op, nbytes) for op, nbytes, _ in stats1)
    sig2 = sorted((op, nbytes) for op, nbytes, _ in stats2)
    assert sig1 == sig2, (
        f"{kind} collective bytes depend on n:\n{sig1}\nvs\n{sig2}")


@pytest.mark.parametrize("n_sub", [None, 256], ids=["full", "subsampled"])
@pytest.mark.parametrize("kind", ["svi", "bpsvi"])
def test_svi_bpsvi_sharded_work_is_flat(cpu_devices, kind, n_sub):
    """Weak scaling of the GSPMD svi/bpsvi builds: per-device compiled
    FLOPs/bytes at 8 devices must match 4 devices when rows PER DEVICE are
    constant (r3's lesson: collectives-only audits miss per-device work
    inflation — a replicated (n, S) projection would double per-device
    work here while keeping collective bytes capped).  The replicated
    context refit is O(cap*d^2 + d^3), constant per device, so the ideal
    ratio is 1.0; gross replication would measure ~2.0."""
    n_per_dev = 1024
    fn = _svi_compiled if kind == "svi" else _bpsvi_compiled

    def cost(ndev):
        mesh = make_mesh({"data": ndev}, devices=jax.devices()[:ndev])
        ca = fn(n_per_dev * ndev, n_sub, mesh).cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return float(ca.get("flops", 0)), float(ca.get("bytes accessed", 0))

    f4, b4 = cost(4)
    f8, b8 = cost(8)
    assert f8 <= f4 * 1.1 and b8 <= b4 * 1.1, (
        f"per-device {kind} build work grows with the mesh at constant "
        f"rows/device: flops {f4} -> {f8}, bytes {b4} -> {b8}")


def test_detector_catches_replicated_v(cpu_devices):
    """The known-bad pattern (plain jitted build GSPMD-auto-partitioned over
    sharded inputs: dynamic row gathers along the sharded axis) must trip
    the same assertions — otherwise the tests above prove nothing."""
    S, n = 32, 2048
    mesh = make_mesh({"data": 8})
    consts, _ = _make_problem(n, S, quantized=False)
    consts = shard_consts(consts, mesh)
    state = snnls.init_state(consts, max_active=256)
    state = shard_state(state, mesh)
    fn = jax.jit(lambda c, s: snnls.build(c, s, 50, config.TOL, method="giga"))
    stats = collective_stats(fn.lower(consts, state).compile().as_text())
    biggest = max(nbytes for _, nbytes, _ in stats)
    # the V all-gather reassembles the full (n, S) f32 matrix
    assert biggest >= n * S * 4, (
        "expected the GSPMD-auto build to all-gather V; if XLA now "
        "partitions dynamic gathers natively, re-benchmark both paths")


def test_spmd_build_bit_matches_gather_build(rng, cpu_devices):
    """Owner-shard extraction selects the same rows and psums them against
    zeros: f32 sharded results must be BIT-identical to the single-device
    gather-based build."""
    S, n = 32, 2048
    A = rng.normal(size=(S, n)).astype(np.float32)
    b = A.sum(axis=1)
    mesh = make_mesh({"data": 8})
    from bayesian_coresets_tpu.parallel import build_sharded
    st = build_sharded(A, b, 60, mesh)
    alg = snnls.GIGA(A, b)
    alg.build(60)
    np.testing.assert_array_equal(np.asarray(st.w), alg.weights())


def _stream_step_lowered(mesh, csize, S=32, d=4):
    """Lower the EXACT SPMD streamed-construction step HilbertCoreset runs
    (shared helper — the scaling harness analyzes the same program)."""
    from bayesian_coresets_tpu.parallel.streamed import (
        lower_stream_step_for_analysis)

    return lower_stream_step_for_analysis(mesh, csize, S, d)


def test_streamed_projection_step_is_spmd(cpu_devices):
    """The streamed-sharded construction step (every device projects its
    OWN rows): its only collective is the O(Sp) b-partial psum — bytes must
    be chunk-size-independent — and per-device compiled work must not grow
    with the mesh size at constant per-device rows (the 'capacity ceiling
    scales with the device count' claim)."""
    S, Sp = 32, 128
    mesh8 = make_mesh({"data": 8})

    c1 = _stream_step_lowered(mesh8, csize=256, S=S)
    c2 = _stream_step_lowered(mesh8, csize=512, S=S)
    for compiled, csize in ((c1, 256), (c2, 512)):
        stats = collective_stats(compiled.as_text())
        assert stats, "the step must psum the b partials"
        for op, nbytes, line in stats:
            assert nbytes <= 4 * Sp * 4, (
                f"stream-step collective beyond O(Sp) ({nbytes} bytes): "
                f"projection is being replicated\n{line[:200]}")
    sig1 = sorted((op, n) for op, n, _ in collective_stats(c1.as_text()))
    sig2 = sorted((op, n) for op, n, _ in collective_stats(c2.as_text()))
    assert sig1 == sig2, "collective bytes depend on the chunk size"

    # weak scaling of the projection phase: per-device FLOPs/bytes at
    # 4 devices == at 8 devices (same per-device chunk rows)
    def per_device_cost(ndev):
        mesh = make_mesh({"data": ndev}, devices=jax.devices()[:ndev])
        ca = _stream_step_lowered(mesh, csize=256, S=S).cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return float(ca.get("flops", 0)), float(ca.get("bytes accessed", 0))

    f4, b4 = per_device_cost(4)
    f8, b8 = per_device_cost(8)
    assert f8 <= f4 * 1.01 and b8 <= b4 * 1.01, (
        f"per-device stream-step work grows with the mesh: "
        f"flops {f4} -> {f8}, bytes {b4} -> {b8}")
