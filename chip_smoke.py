"""Smoke check of the main path on an NVIDIA GPU, phase by phase against a
plain CPU reference.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py                # phases 1-5 on one card
    python chip_smoke.py --four-cards   # the sharded paths on four cards

Phases (one card).  Each is a function that takes its sizes, so the CPU
tests run the same code at a tiny size:

0. precision probe: whether float32 dots at default precision run in TF32,
   and the Poisson, Gaussian and linear-regression projections against
   the reference;
1. Hilbert GIGA build, the README quickstart (logistic regression, d=10,
   Laplace projector with S=500, int8 selection copy, M=500) at N=1M;
2. weighted NUTS (``mcmc.run``, 256 chains) on the phase-1 coreset;
3. SparseVI at the reference's canonical Gaussian settings (N=1000,
   d=200, S=100, opt_itrs=50, M=30);
4. BatchPSVI (N=100k, d=20, S=200, sz=100);
5. streamed int8-resident construction (``stream_chunk_size=1_000_000``)
   at N=8M, then GIGA to M=500.

``--four-cards`` runs only what exists across cards: ``build_sharded`` on a
4-way data mesh, the streamed-sharded SPMD construction and chains sharded
with ``mcmc.run(mesh=...)``, each beside its one-card counterpart.

Every phase is compared with the same public call run in this process on
the host CPU device under ``jax.default_matmul_precision("highest")``, on
the same seeded data; the tolerances and their reasons are in
``check_*`` below.  The script exits non-zero and prints no result line
when JAX finds no GPU or any phase fails.  Every line it prints names the
card and its power limit; the last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time
import traceback

# the CPU reference runs in this process: keep the host backend available
# when the environment names the accelerator platform alone
_PLATFORMS = os.environ.get("JAX_PLATFORMS", "")
if _PLATFORMS and "cpu" not in _PLATFORMS.split(","):
    os.environ["JAX_PLATFORMS"] = _PLATFORMS + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bayesian_coresets_tpu as bc  # noqa: E402
from bayesian_coresets_tpu.coresets.projector import center_lls  # noqa: E402
from bayesian_coresets_tpu.models import gaussian, logistic  # noqa: E402
from bayesian_coresets_tpu.models.laplace import (laplace_approx,  # noqa: E402
                                                  sample_laplace)
from bayesian_coresets_tpu.ops import snnls  # noqa: E402
from bayesian_coresets_tpu.utils import config  # noqa: E402
from bayesian_coresets_tpu.utils.device import card_line, require_gpu  # noqa: E402

# Device-memory bandwidth by device_kind (NVIDIA H100 SXM data sheet).
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# Tolerances against the HIGHEST-precision CPU reference.
PROJ_RTOL = 1e-5       # f32 reorders sums (~1e-7 rel); TF32 keeps ~3 digits,
#                        ~1e-3 rel at d=10, so this bound catches TF32
GIGA_PREFIX = 16       # int8 scores are exact int32 sums: selection can
#                        diverge only at near-ties from f32 rounding of the
#                        direction, so the first 16 picks must agree in order
GIGA_RESID_RTOL = 0.02  # final ||Aw-b||/||b|| within 2 % of the reference
NUTS_Z = 4.0           # |mean - mean_ref| <= 4 sqrt(mcse^2 + mcse_ref^2)
NUTS_MAX_RHAT = 1.01   # max split-R-hat on both runs
KL_FACTOR, KL_SLACK = 1.5, 1e-3  # rKL <= 1.5 rKL_ref + 1e-3: the Monte-Carlo
#                        gradients share keys but rounding lets the
#                        trajectories drift apart


# --------------------------------------------------------------------------
# devices, timing, reporting
# --------------------------------------------------------------------------

def cpu_device():
    return jax.devices("cpu")[0]


@contextlib.contextmanager
def reference():
    """The plain reference: host CPU device, float32 at HIGHEST precision."""
    with jax.default_device(cpu_device()), \
            jax.default_matmul_precision("highest"):
        yield


def _fence(tree):
    jax.block_until_ready(tree)
    return tree


def _timed(fn):
    t0 = time.perf_counter()
    out = _fence(fn())
    return out, time.perf_counter() - t0


def _mem(dev=None) -> dict:
    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return {k: stats.get(k) for k in ("bytes_in_use", "peak_bytes_in_use")}


def _memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _check(name, value, limit, ok) -> dict:
    return {"check": name, "value": value, "limit": limit, "ok": bool(ok)}


# --------------------------------------------------------------------------
# comparisons (pure functions of host arrays; unit-tested on the CPU)
# --------------------------------------------------------------------------

def check_projection(got, ref) -> dict:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref)))
    limit = PROJ_RTOL * float(np.max(np.abs(ref)))
    return _check("projection_max_abs_err", err, limit,
                  got.shape == ref.shape and err <= limit)


def prefix_agreement(order, order_ref, k: int = GIGA_PREFIX) -> int:
    """Length of the common leading run of two selection orders (<= k)."""
    a, b = np.asarray(order)[:k], np.asarray(order_ref)[:k]
    agree = 0
    while agree < min(len(a), len(b)) and a[agree] == b[agree]:
        agree += 1
    return agree


def check_giga(order, resid, wts, order_ref, resid_ref) -> list[dict]:
    agree = prefix_agreement(order, order_ref)
    wts = np.asarray(wts)
    rel = abs(resid - resid_ref) / max(abs(resid_ref), 1e-30)
    return [
        _check("giga_prefix_agreement", agree, GIGA_PREFIX,
               agree == GIGA_PREFIX),
        _check("giga_residual_rel_diff", float(rel), GIGA_RESID_RTOL,
               np.isfinite(resid) and rel <= GIGA_RESID_RTOL),
        _check("giga_weights_finite_nonneg", int(wts.size), None,
               bool(np.all(np.isfinite(wts)) and np.all(wts >= 0))),
    ]


def nuts_summary(samples) -> dict:
    s = np.asarray(samples, np.float64)              # (chains, draws, d)
    ess = np.asarray(bc.mcmc.ess(jnp.asarray(samples)), np.float64)
    rhat = np.asarray(bc.mcmc.split_rhat(jnp.asarray(samples)), np.float64)
    sd = s.reshape(-1, s.shape[-1]).std(axis=0)
    return {"mean": s.mean(axis=(0, 1)), "mcse": sd / np.sqrt(ess),
            "min_ess": float(ess.min()), "max_rhat": float(rhat.max())}


def check_nuts(summ, summ_ref) -> list[dict]:
    z = np.abs(summ["mean"] - summ_ref["mean"]) / np.sqrt(
        summ["mcse"] ** 2 + summ_ref["mcse"] ** 2)
    return [
        _check("nuts_mean_max_z", float(z.max()), NUTS_Z, z.max() <= NUTS_Z),
        _check("nuts_max_rhat", summ["max_rhat"], NUTS_MAX_RHAT,
               summ["max_rhat"] <= NUTS_MAX_RHAT),
        _check("nuts_max_rhat_ref", summ_ref["max_rhat"], NUTS_MAX_RHAT,
               summ_ref["max_rhat"] <= NUTS_MAX_RHAT),
    ]


def check_kl(kl, kl_ref, name) -> dict:
    limit = KL_FACTOR * kl_ref + KL_SLACK
    return _check(name, float(kl), float(limit),
                  np.isfinite(kl) and kl <= limit)


def classify_select_dot(hlo: str, rows: int) -> tuple[str, list[str]]:
    """Which implementation XLA chose for the (rows,S)x(S,2) int8 select
    dot, read from the compiled module's text: the instruction producing
    the s32 (rows, 2) result, and the fusion that calls its computation."""
    want = re.compile(rf"s32\[({rows},2|2,{rows})\]")
    lines = hlo.splitlines()
    hits, callers = [], []
    comp = None
    for ln in lines:
        if ln.rstrip().endswith("{") and " = " not in ln:
            comp = ln.strip().split()[0].lstrip("%")   # computation header
        elif " = " in ln and want.search(ln.split(" = ", 1)[1][:80]):
            hits.append(ln.strip())
            if comp:
                callers += [c.strip() for c in lines
                            if re.search(rf"calls=%{re.escape(comp)}\b", c)]
    seen = " ".join(hits + callers)
    if "custom-call(" in seen and "cublas" in seen:
        kind = "cuBLAS custom call"
    elif "triton" in seen:
        kind = "Triton fusion"
    elif any(" dot(" in h for h in hits):
        kind = "XLA dot"
    elif hits:
        kind = "XLA fusion"
    elif re.search(rf"f32\[({rows},2|2,{rows})\]", hlo) and "s8[" in hlo:
        kind = "convert to f32"
    else:
        kind = "not found"
    return kind, [h[:400] for h in (hits + callers)[:4]]


# --------------------------------------------------------------------------
# data and projectors
# --------------------------------------------------------------------------

def logistic_data(n: int, d: int, seed: int) -> np.ndarray:
    with reference():
        return np.asarray(logistic.gen_synthetic(jax.random.key(seed), n, d))


def laplace_fit(Z):
    """The README quickstart's tangent space: Laplace at the MAP."""
    Z = jnp.asarray(Z)
    return laplace_approx(Z, jnp.ones(Z.shape[0]), jnp.zeros(Z.shape[1]),
                          grad_fn=logistic.grad_th_log_joint,
                          hess_fn=logistic.hess_th_log_joint)


def quickstart_projector(Z, S: int):
    lap = laplace_fit(Z)
    sampler = lambda key, n, wts, pts: sample_laplace(key, lap, n)
    return bc.BlackBoxProjector(sampler, S, logistic.log_likelihood)


def fixed_projector(ths: np.ndarray):
    """Projector on fixed parameter samples, so both devices project
    against bit-identical samples."""
    sampler = lambda key, n, wts, pts: jnp.asarray(ths)
    return bc.BlackBoxProjector(sampler, ths.shape[0], logistic.log_likelihood)


def reference_samples(Z, S: int, seed: int) -> np.ndarray:
    with reference():
        return np.asarray(sample_laplace(jax.random.key(seed), laplace_fit(Z), S))


@jax.jit
def _project(z, ths):
    return center_lls(logistic.log_likelihood(z, ths))


def _giga_outcome(c) -> tuple[np.ndarray, float, np.ndarray]:
    """(selection order, ||Aw-b||/||b||, weights) of a built HilbertCoreset."""
    st = c.snnls.state
    order = np.asarray(st.idcs)[: int(st.size)]
    resid = c.error() / float(c.snnls.consts.bnorm)
    return order, resid, np.asarray(c.get()[0])


def _giga_on_current_device(Z, ths, M, **kw):
    c = bc.HilbertCoreset(Z, fixed_projector(ths), **kw)
    c.build(M)
    return _giga_outcome(c)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_precision(m: int = 4096, k: int = 512, n: int = 256) -> dict:
    """Relative error of f32 dots at default precision against float64:
    ~1e-7 in float32, ~1e-4 and above in TF32."""
    rng = np.random.default_rng(0)
    out = {}
    for tag, (mm, kk, nn) in {"gemm": (m, k, n), "projection": (m, 10, 500),
                              "thin_select": (m, k, 2)}.items():
        a = rng.standard_normal((mm, kk)).astype(np.float32)
        b = rng.standard_normal((kk, nn)).astype(np.float32)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        scale = np.max(np.abs(ref))
        dflt = np.asarray(jnp.dot(a, b))
        high = np.asarray(jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST))
        out[tag] = {"default_rel_err": float(np.max(np.abs(dflt - ref)) / scale),
                    "highest_rel_err": float(np.max(np.abs(high - ref)) / scale)}
    out["tf32_at_default"] = bool(out["gemm"]["default_rel_err"] > 1e-5)
    return {"metrics": out, "checks": []}


def _model_projection_cases(n: int, S: int, seed: int):
    """(name, data, parameter samples, log-likelihood) for each model the
    experiments project besides logistic regression (phase 1 checks that
    one): parameters spread around the truth, so the centered
    log-likelihoods are O(1)."""
    from bayesian_coresets_tpu.models import linreg, poisson
    kd, kt, ky = jax.random.split(jax.random.key(seed), 3)
    with reference():
        zp = poisson.gen_synthetic(kd, n)
        xg = gaussian.gen_synthetic(kd, n, 20)
        xl = jax.random.normal(kd, (n, 10))
        zl = jnp.concatenate(
            [xl, (xl @ jnp.ones(10) + jax.random.normal(ky, (n,)))[:, None]], 1)
        spread = lambda d: 0.3 * jax.random.normal(kt, (S, d))
        cases = [
            ("poisson", zp, jnp.array([1.0, 0.0]) + spread(2),
             poisson.log_likelihood),
            ("gaussian", xg, 1.0 + spread(20),
             lambda x, th: gaussian.log_likelihood(x, th, jnp.eye(20), 0.0)),
            ("linreg", zl, 1.0 + spread(10),
             lambda z, th: linreg.log_likelihood(z, th, 1.0)),
        ]
        return [(name, np.asarray(z), np.asarray(th), ll)
                for name, z, th, ll in cases]


def phase_model_projections(n: int = 100_000, S: int = 500,
                            seed: int = 5) -> dict:
    """The projection of every other model, against the reference, at the
    same tolerance as phase 1's: catches a log-likelihood dot left at the
    default (TF32) precision."""
    m: dict = {"n": n, "S": S}
    checks = []
    for name, z, th, ll in _model_projection_cases(n, S, seed):
        proj = jax.jit(lambda z, th, ll=ll: center_lls(ll(z, th)))
        with reference():
            ref = np.asarray(proj(z, th))
        c = check_projection(np.asarray(proj(z, th)), ref)
        checks.append(dict(c, check=f"{name}_{c['check']}"))
    return {"metrics": m, "checks": checks}


def phase_giga(n: int, n_ref: int, d: int = 10, S: int = 500, M: int = 500,
               seed: int = 0, stream_chunk_size: int | None = None,
               ref_chunk_size: int | None = None) -> dict:
    """GIGA Hilbert coreset through ``HilbertCoreset``: full size on the
    default device (timed), then the n_ref comparison on both devices.

    Without ``stream_chunk_size`` this is the README quickstart with the
    int8 selection copy; with it, the streamed int8-resident construction.
    """
    kw = ({"stream_chunk_size": stream_chunk_size} if stream_chunk_size
          else {"select_dtype": jnp.int8})
    m: dict = {"n": n, "d": d, "S": S, "M": M}
    Z = logistic_data(n, d, seed)
    t0 = time.perf_counter()
    c = bc.HilbertCoreset(Z, quickstart_projector(Z, S), **kw)
    consts = _fence(c.snnls.consts)
    m["construct_s"] = time.perf_counter() - t0
    max_active = int(c.snnls.state.idcs.shape[0])
    m["mem_after_construct"] = _mem()

    t0 = time.perf_counter()
    lowered = snnls.build.lower(consts, c.snnls.state, M, config.TOL,
                                method="giga", matvec_k=max_active)
    compiled = lowered.compile()
    m["compile_s"] = time.perf_counter() - t0
    m["memory_analysis"] = _memory_analysis(compiled)
    sel = consts.Vsel if consts.Vsel.shape[0] else consts.V
    hlo = compiled.as_text()
    m["select_dot"], m["select_dot_hlo"] = classify_select_dot(hlo, sel.shape[0])

    _, m["first_build_s"] = _timed(lambda: (c.build(M), c.snnls.state)[1])
    c.reset()
    _, m["build_s"] = _timed(lambda: (c.build(M), c.snnls.state)[1])
    itrs = int(c.snnls.state.itr)
    st0 = snnls.init_state(consts, jax.random.key(0), max_active)
    st, t_dev = _timed(lambda: compiled(consts, st0, M, config.TOL))
    m["iterations"] = itrs
    m["device_build_s"] = t_dev
    m["ms_per_iteration"] = 1e3 * t_dev / max(int(st.itr), 1)
    m["select_bytes_per_iteration"] = int(sel.size * sel.dtype.itemsize)
    peak = PEAK_HBM_BYTES_PER_S.get(jax.devices()[0].device_kind)
    m["select_roofline_share"] = (
        None if peak is None else
        m["select_bytes_per_iteration"] / peak / (1e-3 * m["ms_per_iteration"]))
    m["mem"] = _mem()
    _, resid, wts = _giga_outcome(c)
    m["residual"] = resid
    m["coreset_size"] = int(wts.size)
    pts = np.asarray(c.get()[1])
    checks = [_check("giga_full_weights_finite_nonneg", int(wts.size), None,
                     bool(np.all(np.isfinite(wts)) and np.all(wts >= 0)
                          and np.isfinite(resid)))]
    del c, consts, sel, st, st0, compiled, lowered

    # comparison at n_ref on identical data and parameter samples
    Zr = logistic_data(n_ref, d, seed + 1)
    ths = reference_samples(Zr, S, seed + 2)
    with reference():
        proj_ref = np.asarray(_project(Zr, ths))
    proj = np.asarray(_project(Zr, ths))
    checks.append(check_projection(proj, proj_ref))
    rkw = ({"stream_chunk_size": ref_chunk_size or n_ref} if stream_chunk_size
           else {"select_dtype": jnp.int8})
    got = _giga_on_current_device(Zr, ths, M, **rkw)
    with reference():
        ref = _giga_on_current_device(Zr, ths, M, **rkw)
    checks += check_giga(got[0], got[1], got[2], ref[0], ref[1])
    m["n_ref"] = n_ref
    m["ref_order_head"] = [int(i) for i in ref[0][:GIGA_PREFIX]]
    m["order_head"] = [int(i) for i in got[0][:GIGA_PREFIX]]
    m["residual_at_n_ref"], m["residual_ref"] = got[1], ref[1]
    return {"metrics": m, "checks": checks, "coreset": (pts, wts)}


def phase_nuts(pts, wts, n_samples: int = 500, chains: int = 256,
               ref_chains: int = 64, seed: int = 1) -> dict:
    """Weighted NUTS on a coreset: ``mcmc.run`` as users call it."""
    pts, wts = np.asarray(pts), np.asarray(wts)
    m: dict = {"chains": chains, "ref_chains": ref_chains,
               "n_samples": n_samples, "coreset_size": int(wts.size)}
    _, m["first_run_s"], _ = bc.mcmc.run(logistic, pts, wts, n_samples,
                                         jax.random.key(seed),
                                         num_chains=chains)
    _, t, res = bc.mcmc.run(logistic, pts, wts, n_samples,
                            jax.random.key(seed), num_chains=chains)
    summ = nuts_summary(res.samples)
    m.update(sample_s=t, samples_per_s=chains * n_samples / t,
             min_ess=summ["min_ess"], max_split_rhat=summ["max_rhat"])
    with reference():
        _, t_ref, res_ref = bc.mcmc.run(logistic, pts, wts, n_samples,
                                        jax.random.key(seed),
                                        num_chains=ref_chains)
        summ_ref = nuts_summary(res_ref.samples)
    m.update(ref_sample_s=t_ref, ref_min_ess=summ_ref["min_ess"],
             ref_max_split_rhat=summ_ref["max_rhat"])
    return {"metrics": m, "checks": check_nuts(summ, summ_ref)}


def _gaussian_setup(N: int, d: int, seed: int):
    """Data, prior (mu0, Sig0inv, Siginv = I) and the closed-form full-data
    posterior (mean, precision) in float64 on the host."""
    with reference():
        x = np.asarray(gaussian.gen_synthetic(jax.random.key(seed), N, d))
    prior = (np.zeros(d), np.eye(d), np.eye(d))
    mu, Sig = _posterior(np.ones(N), x, prior)
    return x, prior, (mu, np.linalg.inv(Sig))


def _posterior(w, x, prior):
    """Weighted conjugate posterior (mean, covariance), float64
    (models/gaussian.py weighted_post)."""
    mu0, Sig0inv, Siginv = prior
    w = np.asarray(w, np.float64)
    x = np.asarray(x, np.float64).reshape(len(w), -1)
    Sig = np.linalg.inv(Sig0inv + w.sum() * Siginv)
    return Sig @ (Sig0inv @ mu0 + Siginv @ (w[:, None] * x).sum(axis=0)), Sig


def _gaussian_projector(d: int, S: int, grad: bool):
    mu0, Sig0inv, Siginv = jnp.zeros(d), jnp.eye(d), jnp.eye(d)
    basis = gaussian.posterior_basis(mu0, Sig0inv, Siginv)

    def sampler(k, n, wts, pts):
        if pts.size == 0:                 # projector-construction probe
            wts, pts = jnp.zeros(1), jnp.zeros((1, d))
        return gaussian.sample_weighted_post_basis(
            k, basis, jnp.asarray(pts), jnp.asarray(wts), n)

    loglik = lambda pts, th: gaussian.log_likelihood(pts, th, Siginv, 0.0)
    gradll = ((lambda pts, th: gaussian.grad_x_log_likelihood(pts, th, Siginv))
              if grad else None)
    return bc.BlackBoxProjector(sampler, S, loglik, gradll)


def _rkl(wts, pts, prior, full) -> float:
    """KL(coreset posterior || full-data posterior), closed form, float64."""
    mu, Sig = _posterior(wts, pts, prior)
    return float(gaussian.kl_divergence_np(mu, Sig, full[0], full[1]))


def _svi_run(x, d, S, M, opt_itrs):
    c = bc.SparseVICoreset(x, _gaussian_projector(d, S, grad=False),
                           opt_itrs=opt_itrs, capacity=M)
    c.build(M)
    return c


def phase_sparsevi(N: int = 1000, d: int = 200, S: int = 100, M: int = 30,
                   opt_itrs: int = 50, seed: int = 1) -> dict:
    x, prior, full = _gaussian_setup(N, d, seed)
    m: dict = {"N": N, "d": d, "S": S, "M": M, "opt_itrs": opt_itrs}
    c, m["first_build_s"] = _timed(lambda: _svi_run(x, d, S, M, opt_itrs))
    c.reset()
    _, m["build_s"] = _timed(lambda: (c.build(M), c.wts)[1])
    m["points_per_s"] = M / m["build_s"]
    wts, pts, _ = c.get()
    with reference():
        cr = _svi_run(x, d, S, M, opt_itrs)
        wr, pr, _ = cr.get()
    m["rkl"], m["rkl_ref"] = _rkl(wts, pts, prior, full), _rkl(wr, pr, prior, full)
    m["coreset_size"] = int(np.size(wts))
    return {"metrics": m, "checks": [check_kl(m["rkl"], m["rkl_ref"], "sparsevi_rkl")]}


def _bpsvi_run(x, d, S, sz, opt_itrs):
    c = bc.BatchPSVICoreset(x, _gaussian_projector(d, S, grad=True),
                            opt_itrs=opt_itrs,
                            n_subsample_opt=max(x.shape[0] // 5, 1))
    c.build(sz)
    return c


def phase_bpsvi(N: int = 100_000, N_ref: int = 10_000, d: int = 20,
                S: int = 200, sz: int = 100, opt_itrs: int = 500,
                seed: int = 2) -> dict:
    m: dict = {"N": N, "N_ref": N_ref, "d": d, "S": S, "sz": sz,
               "opt_itrs": opt_itrs, "n_subsample_opt": N // 5}
    x, prior, full = _gaussian_setup(N, d, seed)
    c, m["first_build_s"] = _timed(lambda: _bpsvi_run(x, d, S, sz, opt_itrs))
    _, m["build_s"] = _timed(lambda: (c.build(sz), c.wts)[1])
    m["rkl_full"] = _rkl(c.wts, c.pts, prior, full)
    checks = [_check("bpsvi_full_finite", m["rkl_full"], None,
                     np.isfinite(m["rkl_full"]) and np.all(np.isfinite(c.wts)))]
    xr, prior_r, full_r = _gaussian_setup(N_ref, d, seed + 1)
    got = _bpsvi_run(xr, d, S, sz, opt_itrs)
    with reference():
        ref = _bpsvi_run(xr, d, S, sz, opt_itrs)
    m["rkl"] = _rkl(got.wts, got.pts, prior_r, full_r)
    m["rkl_ref"] = _rkl(ref.wts, ref.pts, prior_r, full_r)
    checks.append(check_kl(m["rkl"], m["rkl_ref"], "bpsvi_rkl"))
    return {"metrics": m, "checks": checks}


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def _spans(x, ndev: int) -> bool:
    """True when ``x`` is split along axis 0 over ``ndev`` distinct devices."""
    shards = x.addressable_shards
    return (len({s.device for s in shards}) == ndev
            and {s.data.shape[0] for s in shards} == {x.shape[0] // ndev})


def phase_sharded_build(n: int, d: int = 10, S: int = 500, M: int = 500,
                        ndev: int = 4, seed: int = 3) -> dict:
    from bayesian_coresets_tpu.parallel import build_sharded, make_mesh
    mesh = make_mesh({"data": ndev})
    m: dict = {"n": n, "S": S, "M": M, "devices": ndev}
    Z = logistic_data(n, d, seed)
    ths = reference_samples(Z[: min(n, 100_000)], S, seed + 1)
    vecs = _project(Z, ths)
    # the candidate masking HilbertCoreset applies (snnls.above_norm_floor)
    b = jnp.sum(vecs, axis=0)
    valid = jnp.asarray(snnls.above_norm_floor(
        np.asarray(jnp.sqrt(jnp.sum(vecs * vecs, axis=1))),
        float(jnp.linalg.norm(b))))
    A = vecs.T
    del vecs
    kw = dict(valid=valid, select_dtype=jnp.int8, max_active=1024)
    build_sharded(A, b, M, mesh, **kw)                      # compile + warm
    st4, m["sharded_build_s"] = _timed(lambda: build_sharded(A, b, M, mesh, **kw))
    placed = _spans(st4.w, ndev)
    consts1 = snnls.make_consts(A, b, valid=valid, select_dtype=jnp.int8)
    st1 = snnls.build(consts1, snnls.init_state(consts1, max_active=1024),
                      M, config.TOL)
    st1, m["one_card_build_s"] = _timed(lambda: snnls.build(
        consts1, snnls.init_state(consts1, max_active=1024), M, config.TOL))
    w4 = jax.device_put(st4.w, jax.devices()[0])
    bn = float(consts1.bnorm)
    r4 = float(snnls.error(consts1, w4, support=1024)) / bn
    r1 = float(snnls.error(consts1, st1.w, support=1024)) / bn
    o4 = np.asarray(st4.idcs)[: int(st4.size)]
    o1 = np.asarray(st1.idcs)[: int(st1.size)]
    m.update(residual=r4, residual_one_card=r1,
             per_device_mem=[_mem(dv) for dv in jax.devices()[:ndev]])
    checks = [_check("sharded_w_on_devices", ndev, ndev, placed)]
    checks += check_giga(o4, r4, np.asarray(st4.w), o1, r1)
    w = np.asarray(st4.w)
    act = np.flatnonzero(w > 0)
    return {"metrics": m, "checks": checks, "coreset": (Z[act], w[act])}


def phase_streamed_sharded(n: int, d: int = 10, S: int = 500, M: int = 500,
                           chunk: int = 1_000_000, ndev: int = 4,
                           seed: int = 4) -> dict:
    from bayesian_coresets_tpu.parallel import make_mesh
    mesh = make_mesh({"data": ndev})
    m: dict = {"n": n, "S": S, "M": M, "chunk": chunk, "devices": ndev}
    Z = logistic_data(n, d, seed)
    ths = reference_samples(Z[: min(n, 100_000)], S, seed + 1)
    proj = fixed_projector(ths)
    t0 = time.perf_counter()
    c = bc.HilbertCoreset(Z, proj, stream_chunk_size=chunk, mesh=mesh)
    consts = _fence(c.snnls.consts)
    V = consts.V
    m["construct_s"] = time.perf_counter() - t0
    m["mode"] = getattr(c, "streamed_sharded_mode", None)
    m["int8_bytes_per_device"] = int(V.size // ndev)
    placed = _spans(V, ndev)
    # the SPMD cross-check as the constructor ran it (each shard's first
    # selectable row), and the same comparison on each shard's first row,
    # selectable or not: a masked row's stored norm is 1, not its own
    m["spmd_probe"] = c.spmd_probe(Z, proj, consts)
    first = [s.index[0].start or 0 for s in consts.valid.addressable_shards]
    sel = np.asarray(consts.valid[jnp.asarray(first)])
    m["first_row_probe"] = [dict(p, selectable=bool(s)) for p, s in zip(
        c.spmd_probe(Z, proj, consts, rows=first), sel[np.argsort(first)])]
    del consts
    c.build(M)
    c.reset()
    _, m["build_s"] = _timed(lambda: (c.build(M), c.snnls.state)[1])
    order, resid, wts = _giga_outcome(c)
    m["per_device_mem"] = [_mem(dv) for dv in jax.devices()[:ndev]]
    del c, V
    t0 = time.perf_counter()
    c1 = bc.HilbertCoreset(Z, proj, stream_chunk_size=chunk)
    _fence(c1.snnls.consts)
    m["one_card_construct_s"] = time.perf_counter() - t0
    c1.build(M)
    o1, r1, _ = _giga_outcome(c1)
    del c1
    m.update(residual=resid, residual_one_card=r1,
             prefix_agreement=prefix_agreement(order, o1))
    rel = abs(resid - r1) / max(abs(r1), 1e-30)
    checks = [
        _check("streamed_spmd_mode", m["mode"], "spmd", m["mode"] == "spmd"),
        _check("streamed_spmd_probe_rows", len(m["spmd_probe"]), ndev,
               len(m["spmd_probe"]) == ndev
               and all(p["ok"] for p in m["spmd_probe"])),
        _check("streamed_V_on_devices", ndev, ndev, placed),
        _check("streamed_residual_rel_diff", float(rel), GIGA_RESID_RTOL,
               np.isfinite(resid) and rel <= GIGA_RESID_RTOL),
        _check("streamed_weights_finite_nonneg", int(wts.size), None,
               bool(np.all(np.isfinite(wts)) and np.all(wts >= 0))),
    ]
    return {"metrics": m, "checks": checks}


def phase_sharded_nuts(pts, wts, n_samples: int = 500, chains: int = 1024,
                       ndev: int = 4, seed: int = 5) -> dict:
    from bayesian_coresets_tpu.parallel import make_mesh
    mesh = make_mesh({"chains": ndev})
    pts, wts = np.asarray(pts), np.asarray(wts)
    key = jax.random.key(seed)
    m: dict = {"chains": chains, "n_samples": n_samples, "devices": ndev,
               "coreset_size": int(wts.size)}
    bc.mcmc.run(logistic, pts, wts, n_samples, key, num_chains=chains,
                mesh=mesh)
    _, t4, res4 = bc.mcmc.run(logistic, pts, wts, n_samples, key,
                              num_chains=chains, mesh=mesh)
    placed = _spans(res4.samples, ndev)
    bc.mcmc.run(logistic, pts, wts, n_samples, key, num_chains=chains)
    _, t1, res1 = bc.mcmc.run(logistic, pts, wts, n_samples, key,
                              num_chains=chains)
    s4, s1 = nuts_summary(res4.samples), nuts_summary(res1.samples)
    m.update(sample_s=t4, samples_per_s=chains * n_samples / t4,
             one_card_sample_s=t1,
             one_card_samples_per_s=chains * n_samples / t1,
             min_ess=s4["min_ess"], max_split_rhat=s4["max_rhat"],
             one_card_max_split_rhat=s1["max_rhat"])
    checks = [_check("chains_on_devices", ndev, ndev, placed)]
    checks += check_nuts(s4, s1)
    return {"metrics": m, "checks": checks}


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return _jsonable(x.tolist())
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def run_phases(phases, card: str) -> bool:
    """Run (name, fn) phases in order; print one line each.  A phase that
    raises or fails a check fails the run."""
    ok = True
    results = {}
    for name, fn in phases:
        try:
            r = fn(results)
        except Exception:                       # reported, and fails the run
            traceback.print_exc()
            print(json.dumps({"phase": name, "card": card, "ok": False,
                              "error": "exception (see stderr)"}), flush=True)
            ok = False
            continue
        results[name] = r
        passed = all(c["ok"] for c in r["checks"])
        ok &= passed
        print(json.dumps(_jsonable({"phase": name, "card": card, "ok": passed,
                                    **r["metrics"], "checks": r["checks"]})),
              flush=True)
    return ok


def one_card_phases():
    def nuts(res):
        return phase_nuts(*res["giga_build"]["coreset"])
    return [
        ("precision_probe", lambda res: phase_precision()),
        ("model_projections", lambda res: phase_model_projections()),
        ("giga_build", lambda res: phase_giga(1_000_000, 100_000)),
        ("weighted_nuts", nuts),
        ("sparsevi", lambda res: phase_sparsevi()),
        ("bpsvi", lambda res: phase_bpsvi()),
        ("streamed_int8_resident", lambda res: phase_giga(
            8_000_000, 100_000, stream_chunk_size=1_000_000,
            ref_chunk_size=25_000)),
    ]


def four_card_phases():
    def nuts(res):
        return phase_sharded_nuts(*res["sharded_build"]["coreset"])
    return [
        ("sharded_build", lambda res: phase_sharded_build(1 << 22)),
        ("streamed_sharded", lambda res: phase_streamed_sharded(1 << 24)),
        ("sharded_nuts", nuts),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded paths on four cards, nothing else")
    args = ap.parse_args(argv)

    dev = require_gpu(4 if args.four_cards else 1)
    card = card_line()
    print(card, flush=True)
    bc.utils.enable_compilation_cache()

    phases = four_card_phases() if args.four_cards else one_card_phases()
    if not run_phases(phases, card):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
