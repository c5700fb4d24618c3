"""Head-to-head: on-device convergence mechanisms on the hardest
weighted coreset posteriors (airportdelays / biketrips, regular + _large).

Round 2 left the framework converging these posteriors on the HOST (a CPU
retry was the operative mechanism; accelerator split-R-hat reached 16-74
on biketrips_large).  This script measures, per (dataset, coreset), each
on-device arm on identical coreset weights:

  naive+diag    round-2 status quo: mode-relative density via f32
                subtraction of full log-likelihoods, diagonal mass
  naive+dense   + dense mass-matrix adaptation (Stan dense_e analogue)
  stable+diag   stable pairwise-difference likelihood
                (models.*.log_likelihood_diff), diagonal mass
  stable+dense  both
  cpu           the retired fallback, for reference (stable+diag on host)

and reports split-R-hat / min-ESS / samples-per-second for each.  The
coreset itself is built once per dataset (GIGA-OPT, the driver's flagship
config) at a size that round 2 recorded as failing.

Usage: python scripts/bench_hard_posteriors.py [--datasets biketrips_large ...]
Writes one JSON line per (dataset, arm).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASETS = ["biketrips", "airportdelays", "biketrips_large",
            "airportdelays_large", "synth_poiss_large"]
M_BUILD = 300          # coreset iterations (driver grid reaches this zone)


def build_coreset(model, Z, S, key, m):
    import jax
    import jax.numpy as jnp

    from bayesian_coresets_tpu import coresets as bc
    from bayesian_coresets_tpu.models.laplace import laplace_approx, sample_laplace

    N, dz = Z.shape
    dth = dz - 1  # poisson convention (all hard datasets are poisson)
    lap = laplace_approx(Z, jnp.ones(N), jnp.zeros(dth),
                         grad_fn=model.grad_th_log_joint,
                         hess_fn=model.hess_th_log_joint)
    sampler = lambda k, n, w, p: sample_laplace(k, lap, n)
    alg = bc.HilbertCoreset(Z, bc.BlackBoxProjector(sampler, S, model.log_likelihood),
                            seed=1, select_dtype=jnp.int8)
    alg.build(m)
    wts, pts, _ = alg.get()
    return np.asarray(wts, np.float32), np.asarray(pts, np.float32)


def pad_pow2(pts, wts, dz):
    pad = 1 << int(np.ceil(np.log2(max(pts.shape[0], 8))))
    pts = np.vstack([pts, np.zeros((pad - pts.shape[0], dz), np.float32)])
    wts = np.concatenate([wts, np.zeros(pad - wts.shape[0], np.float32)])
    return pts, wts


def naive_model(model):
    """The same model namespace WITHOUT log_likelihood_diff: forces
    weighted_logdensity onto the round-2 naive subtraction path."""
    ns = types.SimpleNamespace()
    for name in dir(model):
        if not name.startswith("__") and name != "log_likelihood_diff":
            setattr(ns, name, getattr(model, name))
    return ns


def run_arm(model, pts, wts, dth, dense, key, on_cpu=False,
            samples=1000, warmup=2000, chains=8):
    import jax
    import jax.numpy as jnp

    from bayesian_coresets_tpu import mcmc

    def go():
        return mcmc.run(model, jnp.asarray(pts), jnp.asarray(wts),
                        -(-samples // chains), key, d=dth, num_chains=chains,
                        target_accept=0.9, pooled_adaptation=True,
                        num_warmup=warmup, max_depth=15, dense_mass=dense)

    if on_cpu:
        with jax.default_device(jax.devices("cpu")[0]):
            _, t, res = go()
    else:
        _, t, res = go()
    rhat = float(np.max(np.asarray(mcmc.split_rhat(res.samples))))
    ess = float(np.min(np.asarray(mcmc.ess(res.samples))))
    nkept = res.samples.shape[0] * res.samples.shape[1]
    return {"rhat": round(rhat, 3), "min_ess": round(ess, 1),
            "samples_per_s": round(nkept / t, 1), "wall_s": round(t, 1)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="*", default=DATASETS)
    p.add_argument("--arms", nargs="*",
                   default=["naive+diag", "naive+dense", "stable+diag",
                            "stable+dense"])
    p.add_argument("--m", type=int, default=M_BUILD)
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=2000)
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend for the whole script")
    args = p.parse_args()
    if args.cpu:
        import jax as _jax
        _jax.config.update("jax_platforms", "cpu")

    import jax

    from bayesian_coresets_tpu.experiments import datasets
    from bayesian_coresets_tpu.models import poisson
    from bayesian_coresets_tpu.utils import prng

    out = []
    for ds in args.datasets:
        X, Y, Z, Zt, D = datasets.load_poisson(ds)
        Z = np.asarray(Z, np.float32)
        N, dz = Z.shape
        dth = dz - 1
        key = prng.fold_seed(1)
        import jax.numpy as jnp
        wts, pts = build_coreset(poisson, jnp.asarray(Z), 500, key, args.m)
        pts, wts = pad_pow2(pts, wts, dz)
        print(f"# {ds}: N={N} coreset support={(wts > 0).sum()} "
              f"max_w={wts.max():.1f}", flush=True)
        for arm in args.arms:
            if arm == "cpu":
                lik, mass = "stable", "diag"
            else:
                lik, mass = arm.split("+")
            model = poisson if lik == "stable" else naive_model(poisson)
            key, k = jax.random.split(key)
            r = run_arm(model, pts, wts, dth, mass == "dense", k,
                        on_cpu=(arm == "cpu"), samples=args.samples,
                        warmup=args.warmup, chains=args.chains)
            row = {"dataset": ds, "arm": arm, **r}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
