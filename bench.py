"""Throughput benchmark on one GPU: coreset construction at M=500, the
int8-resident build at N=8M, SparseVI at the reference's canonical Gaussian
settings, and weighted NUTS on the coreset the headline build produced.

Workloads (the reference's simple_lr/logistic flagship path, SURVEY.md
§3.1):
- headline: N=100k logistic-regression points, S=500 projection samples,
  GIGA Hilbert coreset to M=500 with the int8 selection copy.  The timed
  region is one jitted pipeline: log-likelihood projection, snnls constants
  and 500 greedy iterations.  The same build at N=1M is reported beside it
  (its 512 MB int8 select copy is larger than the card's L2 cache);
- N=8M int8-resident build (streamed construction, no f32 (n, S) ever
  materialized), construction reported as set-up;
- SparseVI: N=1000, d=200, S=100, opt_itrs=50, M=30;
- weighted NUTS: 1024 chains x 150 kept draws on the headline coreset.

Baselines (host CPU, recorded when this benchmark was written and not
re-measured since): the reference numpy/scipy implementation took 80.1 s
(6.24 points/s) for projection + build on the headline workload and 46.4 s
for the SparseVI workload; this framework's single-chain CPU NUTS drew 49
samples/s (pystan was not installed, and the reference hardcodes chains=1).

Timing: host clock around calls fenced with ``block_until_ready``, after a
warm-up call that compiles; the median of the repetitions is reported.
Every line names the platform, the device kind, and the card's name and
power limit.  Without a GPU the script exits non-zero.

Run: python bench.py      (one JSON line per metric; the LAST line is the
headline {"metric", "value", "unit", "vs_baseline"})
"""

import json
import time

N, D, S, M = 100_000, 10, 500, 500
REFERENCE_CPU_POINTS_PER_S = 6.24     # projection + build, see above
REFERENCE_CPU_SPARSEVI_S = 46.4       # reference SparseVI to M=30, see above
CPU_1CHAIN_NUTS_SAMPLES_PER_S = 49.0  # see above
NUTS_CHAINS, NUTS_DRAWS = 1024, 150


def _median_time(fn, reps):
    """Median wall seconds of ``fn()`` (fenced) over ``reps`` calls, and
    the last result."""
    import jax

    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(i))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times, out


def _make_build(jax, jnp):
    from bayesian_coresets_tpu.coresets.projector import center_lls
    from bayesian_coresets_tpu.models import logistic
    from bayesian_coresets_tpu.ops import snnls

    @jax.jit
    def build(z, key):
        # fixed near-MAP Gaussian sampler (simple_lr-style tangent space)
        ths = 0.1 * jax.random.normal(key, (S, D), jnp.float32)
        vecs = center_lls(logistic.log_likelihood(z, ths))       # (n, S)
        # int8 selection copy: a quarter of the score matmul's traffic
        # (rows pre-normalized); weights, reweighting and the error check
        # stay f32 (tests/test_snnls.py::test_reduced_precision_select)
        consts = snnls.make_consts(vecs.T, jnp.sum(vecs, axis=0),
                                   select_dtype=jnp.int8)
        # support slots: the periodic exact-matvec refresh gathers the
        # <=1024 tracked rows instead of streaming the full f32 (n, S) V
        state = snnls.init_state(consts, max_active=1024)
        state = snnls.build(consts, state, M, 1e-6, method="giga")
        return state.w

    return build


def _n8m_resident_arm(jax, jnp):
    """int8-RESIDENT build at N=8M: the streamed constructor's layout (no
    f32 (n, S) ever materialized), 500 GIGA iterations over a 4.1 GB
    int8 matrix."""
    from bayesian_coresets_tpu.coresets.projector import center_lls
    from bayesian_coresets_tpu.coresets.hilbert import _write_chunk
    from bayesian_coresets_tpu.models import logistic
    from bayesian_coresets_tpu.ops import snnls
    from bayesian_coresets_tpu.parallel.streamed import quantize_chunk

    N8, CH = 8_000_000, 1_000_000
    rows = -(-N8 // 1024) * 1024
    Sp = -(-S // 128) * 128
    ths = 0.1 * jax.random.normal(jax.random.key(7), (S, D), jnp.float32)

    @jax.jit
    def project_chunk(z):
        q, nrm, bsum = quantize_chunk(
            center_lls(logistic.log_likelihood(z, ths)), jnp.int32(CH))
        return jnp.pad(q, ((0, 0), (0, Sp - q.shape[1]))), nrm, bsum

    t0 = time.perf_counter()
    buf = jnp.zeros((rows, Sp), jnp.int8)
    b = jnp.zeros((S,), jnp.float32)
    norm_chunks = []
    for c in range(N8 // CH):
        z = logistic.gen_synthetic(jax.random.key(100 + c), CH, D)
        q, nrm, bsum = project_chunk(z)
        buf, b = _write_chunk(buf, q, jnp.int32(c * CH), b, bsum)
        norm_chunks.append(nrm)
    norms = jnp.pad(jnp.concatenate(norm_chunks), (0, rows - N8),
                    constant_values=1.0)
    valid = jnp.arange(rows) < N8
    consts = jax.block_until_ready(snnls.make_consts_quantized(
        buf, norms, jnp.pad(b, (0, Sp - S)), valid=valid))
    t_construct = time.perf_counter() - t0

    def build(i):
        state = snnls.init_state(consts, jax.random.key(8 + i), max_active=1024)
        return snnls.build(consts, state, M, 1e-6, method="giga",
                           matvec_k=1024).w

    build(0).block_until_ready()                        # compile + warm
    t, _, _ = _median_time(lambda i: build(1 + i), reps=3)
    return {
        "metric": "coreset_points_per_sec_N8M_int8_resident",
        "value": round(M / t, 2),
        "unit": "points/s",
        "per_iter_ms": round(1e3 * t / M, 3),
        "implied_select_gbps": round(M * rows * Sp / 1e9 / t, 1),
        "construction_s": round(t_construct, 2),
    }


def _sparsevi_arm(jax, jnp):
    """SparseVI at the reference-canonical gaussian config (N=1000, d=200,
    S=100, opt_itrs=50, M=30; reference coreset/sparsevi.py:16-76, SURVEY
    §3.2 calls this THE dominant compute pattern)."""
    import bayesian_coresets_tpu as bc
    from bayesian_coresets_tpu.coresets.sparsevi import svi_build
    from bayesian_coresets_tpu.models import gaussian

    Ns, d, Ss, Ms, opt_itrs = 1000, 200, 100, 30, 50
    x = gaussian.gen_synthetic(jax.random.key(1), Ns, d)
    mu0, Sig0inv, Siginv = jnp.zeros(d), jnp.eye(d), jnp.eye(d)
    basis = jax.jit(gaussian.posterior_basis)(mu0, Sig0inv, Siginv)

    def sampler(k, n, wts, pts):
        if pts.size == 0:                 # projector-construction probe
            wts, pts = jnp.zeros(1), jnp.zeros((1, d))
        return gaussian.sample_weighted_post_basis(
            k, basis, jnp.asarray(pts), jnp.asarray(wts), n)

    loglik = lambda pts, th: gaussian.log_likelihood(pts, th, Siginv, 0.0)
    prj = bc.BlackBoxProjector(sampler, Ss, loglik)
    sched = lambda i: 1.0 / (1.0 + i)
    cap = 32
    w0, i0 = jnp.zeros(cap), jnp.full(cap, -1, jnp.int32)

    def one(i):
        return svi_build(x, w0, i0, jnp.int32(0), jax.random.key(2 + i),
                         jnp.int32(Ms), family=prj.family, n_sub_sel=None,
                         n_sub_opt=None, opt_itrs=opt_itrs, step_sched=sched)

    jax.block_until_ready(one(0))                     # compile + warm
    t, _, _ = _median_time(lambda i: one(1 + i), reps=5)
    steps = Ms * (1 + opt_itrs)      # select + opt_itrs contexts per iter
    return {
        "metric": "sparsevi_points_per_sec_canonical",
        "value": round(Ms / t, 1),
        "unit": "points/s",
        "vs_baseline": round(REFERENCE_CPU_SPARSEVI_S / t, 1),
        "build_s": round(t, 4),
        "us_per_adam_step": round(1e6 * t / steps, 1),
    }


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    from bayesian_coresets_tpu.models import logistic
    from bayesian_coresets_tpu.utils import (card_line,
                                             enable_compilation_cache,
                                             require_gpu)

    dev = require_gpu()
    tag = {"platform": dev.platform, "device_kind": dev.device_kind,
           "card": card_line()}
    enable_compilation_cache()

    def emit(line):
        print(json.dumps({**line, **tag}), flush=True)

    Z = logistic.gen_synthetic(jax.random.key(0), N, D)
    build = _make_build(jax, jnp)
    build(Z, jax.random.key(1)).block_until_ready()          # compile + warm
    t_100k, times, w_last = _median_time(
        lambda i: build(Z, jax.random.key(2 + i)), reps=5)

    Z1 = logistic.gen_synthetic(jax.random.key(3), 1_000_000, D)
    build(Z1, jax.random.key(4)).block_until_ready()
    t_1m, _, _ = _median_time(lambda i: build(Z1, jax.random.key(5 + i)),
                              reps=3)
    del Z1

    emit(_n8m_resident_arm(jax, jnp))
    emit(_sparsevi_arm(jax, jnp))

    # weighted NUTS on the coreset the headline build produced
    from bayesian_coresets_tpu import mcmc as MC
    from bayesian_coresets_tpu.mcmc import weighted

    w_host = np.asarray(w_last)
    act = np.flatnonzero(w_host > 0)
    zc = jnp.asarray(np.asarray(Z)[act])
    wc = jnp.asarray(w_host[act])

    def run_nuts(i):
        # mcmc.run fences its own result; its wall time includes tracing
        return weighted.run(logistic, zc, wc, NUTS_DRAWS, jax.random.key(6 + i),
                            num_chains=NUTS_CHAINS, target_accept=0.8,
                            num_warmup=NUTS_DRAWS)[2]

    run_nuts(0)                                              # compile + warm
    t_nuts, _, res = _median_time(lambda i: run_nuts(1 + i), reps=3)
    nuts_sps = NUTS_CHAINS * NUTS_DRAWS / t_nuts
    emit({
        "metric": f"weighted_nuts_samples_per_sec_{NUTS_CHAINS}chains",
        "value": round(nuts_sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(nuts_sps / CPU_1CHAIN_NUTS_SAMPLES_PER_S, 2),
        "chains": NUTS_CHAINS,
        "kept_draws_per_chain": NUTS_DRAWS,
        "min_ess_per_s": round(float(np.min(np.asarray(MC.ess(res.samples))))
                               / t_nuts, 1),
        "max_split_rhat": round(float(np.max(np.asarray(
            MC.split_rhat(res.samples)))), 4),
        "coreset_size": int(act.size),
    })

    pts_per_s = M / t_100k
    rows, sp = -(-N // 1024) * 1024, -(-S // 128) * 128
    emit({
        "metric": "coreset_points_per_sec_per_chip_M500",
        "value": round(pts_per_s, 2),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / REFERENCE_CPU_POINTS_PER_S, 2),
        "reps": len(times),
        "points_per_s_min": round(M / times[-1], 2),
        "points_per_s_max": round(M / times[0], 2),
        "implied_select_gbps": round(M * rows * sp / 1e9 / t_100k, 1),
        "points_per_s_N1M": round(M / t_1m, 2),
        "implied_select_gbps_N1M": round(
            M * (-(-1_000_000 // 1024) * 1024) * sp / 1e9 / t_1m, 1),
    })


if __name__ == "__main__":
    main()
