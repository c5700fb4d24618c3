"""Reference-canonical linear-regression parity run.

Config = the reference's own defaults (examples/linear_regression/main.py:
280-288): N=10 000 rows, 6x50+1=301 RBF bases, proj_dim S=100, six
log-spaced coreset sizes to M=300.  The reference's prices2018.npy is not
distributed, so BOTH sides run on the same synthetic-housing stand-in
(experiments/datasets.gen_synthetic_housing), with identical Z / basis
matrices per trial — the comparison isolates the algorithms.

Reference side: the actual numpy/scipy code imported from /root/reference
(bayesiancoresets.HilbertCoreset / UniformSamplingCoreset with a
BlackBoxProjector over model_linreg), executed in-process on CPU.  SVI is
excluded from the reference arm: at this scale its inner loop re-projects
all N rows on every one of opt_itrs x M gradient steps (~1e13 numpy flops,
hours per trial); SVI quality parity is held by the gaussian-scale tests.

Ours: the same GIGA-OPT / US algorithms through bayesian_coresets_tpu on
forced-CPU JAX (quality parity is hardware-independent).

Writes results/parity_linreg_canonical.json and prints a markdown table of
per-M rKL medians over trials.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DATA, S_PROJ, M_MAX, N_SIZES, N_TRIALS = 10_000, 100, 300, 6, 3


def make_problem(trial):
    """Data + RBF bases exactly as our driver builds them (which mirrors the
    reference's main.py:60-108 recipe) — shared verbatim by both sides."""
    from bayesian_coresets_tpu.experiments import datasets

    rng = np.random.default_rng(trial)
    x = datasets.gen_synthetic_housing(rng, N_DATA)
    datastd = x[:, 2].std()
    datamn = x[:, 2].mean()
    sigsq = datastd**2

    scales_u = np.array([0.2, 0.4, 0.8, 1.2, 1.6, 2.0, 100.0])
    counts_u = np.hstack((50 * np.ones(6, dtype=np.int64), 1))
    d = int(counts_u.sum())
    mu0 = datamn * np.ones(d)
    Sig0 = (datastd**2 + datamn**2) * np.eye(d)
    Sig0inv = np.linalg.inv(Sig0)

    basis_scales = np.array([])
    basis_locs = np.zeros((0, 2))
    for i in range(scales_u.shape[0]):
        basis_scales = np.hstack((basis_scales, scales_u[i] * np.ones(counts_u[i])))
        idcs = rng.choice(np.arange(x.shape[0]), replace=False, size=counts_u[i])
        basis_locs = np.vstack((basis_locs, x[idcs, :2]))

    X = np.exp(-((x[:, None, :2] - basis_locs[None, :, :]) ** 2).sum(-1)
               / (2.0 * basis_scales[None, :] ** 2))
    Y = x[:, 2]
    Z = np.hstack((X, Y[:, None]))
    return Z, mu0, Sig0, Sig0inv, sigsq, d


def m_grid():
    Ms = np.unique(np.logspace(0.0, np.log10(M_MAX), N_SIZES, dtype=np.int64))
    return Ms


def run_reference(Z, mu0, Sig0, Sig0inv, sigsq, trial):
    sys.path.insert(0, "/root/reference")
    sys.path.insert(0, "/root/reference/examples/common")
    import bayesiancoresets as bc_ref
    import model_linreg

    np.random.seed(trial)
    mup, USigp, LSigpInv = model_linreg.weighted_post(
        mu0, Sig0inv, sigsq, Z, np.ones(Z.shape[0]))
    SigpInv = LSigpInv.dot(LSigpInv.T)

    loglik = lambda z, th: model_linreg.log_likelihood(z, th, sigsq)
    sampler_optimal = lambda n, w, pts: mup + np.random.randn(n, mup.shape[0]).dot(USigp.T)
    out = {}
    for name in ("GIGA-OPT", "US"):
        np.random.seed(trial)
        if name == "GIGA-OPT":
            prj = bc_ref.BlackBoxProjector(sampler_optimal, S_PROJ, loglik)
            alg = bc_ref.HilbertCoreset(Z, prj)
        else:
            alg = bc_ref.UniformSamplingCoreset(Z)
        rkls, t0, prev = [], time.perf_counter(), 0
        for M in m_grid():
            alg.build(int(M) - prev)
            prev = int(M)
            wts, pts, _ = alg.get()
            muw, USigw, _ = model_linreg.weighted_post(mu0, Sig0inv, sigsq,
                                                       pts, wts)
            rkls.append(float(model_linreg.KL(muw, USigw.dot(USigw.T),
                                              mup, SigpInv)))
        out[name] = {"rkl": rkls, "wall_s": time.perf_counter() - t0}
    return out


def run_ours(Z, mu0, Sig0, Sig0inv, sigsq, trial):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import bayesian_coresets_tpu as bct
    from bayesian_coresets_tpu.models import linreg
    from bayesian_coresets_tpu.models.gaussian import kl_divergence_np

    Zj = jnp.asarray(Z, jnp.float32)
    mu0_j = jnp.asarray(mu0, jnp.float32)
    Sig0inv_j = jnp.asarray(Sig0inv, jnp.float32)
    n = Z.shape[0]
    post = linreg.weighted_post(mu0_j, Sig0inv_j, sigsq, Zj, jnp.ones(n))
    mup = np.asarray(post.mu)
    SigpInv = np.asarray(post.LSigInv @ post.LSigInv.T)

    loglik = lambda pts, th: linreg.log_likelihood(pts, th, sigsq)

    def sampler_optimal(k, m, w, p):
        return linreg.sample_weighted_post(k, mu0_j, Sig0inv_j, sigsq, Zj,
                                           jnp.ones(n), m)

    out = {}
    for name in ("GIGA-OPT", "US"):
        if name == "GIGA-OPT":
            alg = bct.HilbertCoreset(
                Zj, bct.BlackBoxProjector(sampler_optimal, S_PROJ, loglik),
                seed=trial)
        else:
            alg = bct.UniformSamplingCoreset(Zj, seed=trial)
        rkls, t0, prev = [], time.perf_counter(), 0
        for M in m_grid():
            alg.build(int(M) - prev)
            prev = int(M)
            wts, pts, _ = alg.get()
            pts_m = jnp.asarray(np.atleast_2d(np.asarray(pts, np.float32)))
            wts_m = jnp.asarray(np.asarray(wts, np.float32))
            if wts_m.shape[0] == 0:
                pts_m = jnp.zeros((1, Z.shape[1]), jnp.float32)
                wts_m = jnp.zeros(1, jnp.float32)
            wp = linreg.weighted_post(mu0_j, Sig0inv_j, sigsq, pts_m, wts_m)
            rkls.append(float(kl_divergence_np(
                np.asarray(wp.mu), np.asarray(wp.USig @ wp.USig.T),
                mup, SigpInv)))
        out[name] = {"rkl": rkls, "wall_s": time.perf_counter() - t0}
    return out


def main():
    Ms = m_grid()
    ref_runs, our_runs = {}, {}
    for trial in range(1, N_TRIALS + 1):
        Z, mu0, Sig0, Sig0inv, sigsq, d = make_problem(trial)
        print(f"# trial {trial}: N={Z.shape[0]} d={d} S={S_PROJ} Ms={list(Ms)}",
              flush=True)
        ref_runs[trial] = run_reference(Z, mu0, Sig0, Sig0inv, sigsq, trial)
        print(f"  reference done "
              f"({ {k: round(v['wall_s'], 1) for k, v in ref_runs[trial].items()} }s)",
              flush=True)
        our_runs[trial] = run_ours(Z, mu0, Sig0, Sig0inv, sigsq, trial)
        print(f"  ours done "
              f"({ {k: round(v['wall_s'], 1) for k, v in our_runs[trial].items()} }s)",
              flush=True)

    artifact = {
        "config": {"N": N_DATA, "d": 301, "S": S_PROJ, "Ms": [int(m) for m in Ms],
                   "trials": N_TRIALS,
                   "source": "reference examples/linear_regression/main.py:280-288 defaults",
                   "data": "synthetic housing stand-in (prices2018.npy not distributed); "
                           "identical Z per trial for both sides"},
        "reference": ref_runs, "ours": our_runs,
    }
    os.makedirs("results", exist_ok=True)
    with open("results/parity_linreg_canonical.json", "w") as f:
        json.dump(artifact, f, indent=1)

    for name in ("GIGA-OPT", "US"):
        ref_med = np.median([ref_runs[t][name]["rkl"] for t in ref_runs], axis=0)
        our_med = np.median([our_runs[t][name]["rkl"] for t in our_runs], axis=0)
        print(f"\n## {name}")
        print("| M | " + " | ".join(str(int(m)) for m in Ms) + " |")
        print("|---" * (len(Ms) + 1) + "|")
        print("| reference rKL | " + " | ".join(f"{v:.3g}" for v in ref_med) + " |")
        print("| ours rKL | " + " | ".join(f"{v:.3g}" for v in our_med) + " |")


if __name__ == "__main__":
    main()
