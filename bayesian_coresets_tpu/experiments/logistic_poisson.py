"""Logistic / Poisson regression coreset experiment with weighted NUTS.

Driver with the capability surface of the reference's
``examples/logistic_poisson_regression/main.py``: real datasets, cached
full-data MCMC, Laplace-based projectors (tuned / untuned / black-box),
four algorithms (SVI, GIGA-OPT, GIGA-REAL, US), per-size weighted-NUTS
coreset posteriors, and metrics (reverse/forward KL vs the moment-matched
full posterior, relative mean/cov errors, gradient F-norm Fs, build and
MCMC timings).  The reference's Stan C++ weighted sampler is replaced by
the pure-JAX weighted NUTS (mcmc/).

Run:  python -m bayesian_coresets_tpu.experiments.logistic_poisson run \
          --model lr --dataset synth_lr --alg GIGA-OPT --trial 1
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import coresets as bc
from .. import mcmc
from ..models import logistic, poisson
from ..models.gaussian import kl_divergence_np
from ..models.laplace import laplace_approx, sample_laplace
from ..utils import prng, set_verbosity
from . import datasets, results
from .cli import coreset_size_grid, make_parser, step_sched

ALGS = ["SVI", "GIGA-OPT", "GIGA-REAL", "US", "BPSVI"]

# convergence gates on the samples feeding the quality metrics (Vehtari et
# al. 2021: gate BOTH mixing and sample size — an R-hat of 1.01 with a bulk
# ESS of 15 is still a worthless estimate).  Runs failing either gate are
# retried (see below) and warned about loudly.
RHAT_GATE = 1.1     # max split-R-hat over dims (1.01 production, 1.1 failure)
ESS_GATE = 100.0    # min bulk-ESS over dims (Vehtari et al. recommend >=100)


def unconverged(rhat: float, ess_v: float, ess_gate: float = ESS_GATE) -> bool:
    return rhat > RHAT_GATE or ess_v < ess_gate


def full_cache_path(arguments) -> str:
    """Full-data MCMC cache file for these arguments.

    The reference keyed its cache only by (model, dataset)
    (examples/logistic_poisson_regression/main.py:107-127), so changing the
    sample count, chain setup, or trial silently reused stale samples.  The
    key here covers every input that changes the cached chains.
    """
    tag = (f"{arguments.model}_{arguments.dataset}"
           f"_n{arguments.mcmc_samples_full}_c{arguments.mcmc_chains}"
           f"_a{arguments.target_accept}_d{arguments.max_treedepth}"
           f"_t{arguments.trial}"
           + ("_dm" if getattr(arguments, "dense_mass", False) else ""))
    return os.path.join("mcmc_cache", f"full_samples_{tag}.npz")


def chain_diagnostics(res) -> tuple[float, float]:
    """(max split-R-hat over dims, min ESS over dims) for an MCMCResult."""
    rhat = float(np.max(np.asarray(mcmc.split_rhat(res.samples))))
    ess_v = float(np.min(np.asarray(mcmc.ess(res.samples))))
    return rhat, ess_v


def run(arguments):
    import jax
    import jax.numpy as jnp

    if results.check_exists(arguments):
        print(f"Results already exist for arguments {arguments}\nQuitting.")
        return
    set_verbosity(arguments.verbosity)

    Ms = coreset_size_grid(arguments.coreset_size_max, arguments.coreset_num_sizes,
                           arguments.coreset_size_spacing, with_zero=False)

    if arguments.model == "lr":
        model = logistic
        X, Y, Z, Zt, D = datasets.load_logistic(arguments.dataset)
    else:
        model = poisson
        X, Y, Z, Zt, D = datasets.load_poisson(arguments.dataset)
    Z = jnp.asarray(Z)
    N, dz = Z.shape
    # theta dimension: lr folds y into z (theta dim = dz); poisson appends the
    # count column (theta dim = dz - 1)
    dth = dz if arguments.model == "lr" else dz - 1
    key = prng.fold_seed(arguments.trial)

    # full-data posterior via weighted NUTS, cached (reference main.py:107-127;
    # cache key fixed to cover sample count / chains / trial, see
    # full_cache_path).  Chains are vmapped with pooled adaptation: a single
    # chain is a sequence of tiny dependent ops that leaves the device idle.
    nc = max(1, int(arguments.mcmc_chains))
    mesh = None
    if getattr(arguments, "chain_mesh", False):
        # route all NUTS through the framework's multi-device chain sharding
        # (parallel/mcmc.py): on several devices each one runs its resident
        # chains; on one device this is a no-op placement.  Chains round up
        # to a multiple of the device count.
        from ..parallel.mesh import CHAIN_AXIS, make_mesh
        ndev = len(jax.devices())
        nc = -(-nc // ndev) * ndev
        mesh = make_mesh({CHAIN_AXIS: ndev})
        print(f"chain mesh: {ndev} devices x {nc // ndev} chains/device")
    n_full = -(-arguments.mcmc_samples_full // nc)   # kept draws per chain
    cache = full_cache_path(arguments)
    if os.path.exists(cache):
        print("Full MCMC cache exists, loading")
        with np.load(cache) as tmp:
            full_samples = tmp["samples"]
            full_mcmc_time_per_itr = float(tmp["t"])
            full_rhat = float(tmp["rhat"])
            full_ess = float(tmp["ess"])
    else:
        print(f"Running full-data MCMC ({nc} chains x {n_full} draws)")
        key, kmc = jax.random.split(key)
        # warmup = the full single-chain burn length (reference iter=2N
        # convention): adaptation quality must not shrink with chain count
        full_samples, t_full, res_full = mcmc.run(
            model, Z, jnp.ones(N), n_full, kmc, d=dth, num_chains=nc,
            target_accept=arguments.target_accept, pooled_adaptation=nc > 1,
            num_warmup=arguments.mcmc_samples_full,
            max_depth=arguments.max_treedepth,
            dense_mass=arguments.dense_mass, mesh=mesh)
        full_samples = np.asarray(full_samples)
        full_rhat, full_ess = chain_diagnostics(res_full)
        full_mcmc_time_per_itr = t_full / (nc * n_full * 2)
        os.makedirs("mcmc_cache", exist_ok=True)
        np.savez(cache, samples=full_samples, t=full_mcmc_time_per_itr,
                 rhat=full_rhat, ess=full_ess)
    if unconverged(full_rhat, full_ess, arguments.ess_gate):
        print(f"WARNING: full-data chains not converged "
              f"(max split-R-hat {full_rhat:.3f} > {RHAT_GATE} or "
              f"min ESS {full_ess:.0f} < {arguments.ess_gate}); "
              f"metrics below compare against unconverged samples")

    mup = full_samples.mean(axis=0)
    Sigp = np.cov(full_samples, rowvar=False)
    SigpInv = np.linalg.inv(Sigp)

    # Laplace-based projectors (reference main.py:142-163)
    print("Fitting Laplace approximations")
    lap_opt = laplace_approx(Z, jnp.ones(N), jnp.zeros(dth),
                             grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint)
    key, ksub = jax.random.split(key)
    sub = jax.random.randint(ksub, (int(np.sqrt(N)),), 0, N)
    Zhat = Z[sub]
    lap_real = laplace_approx(Zhat, jnp.ones(Zhat.shape[0]), jnp.zeros(dth),
                              grad_fn=model.grad_th_log_joint,
                              hess_fn=model.hess_th_log_joint)

    S = arguments.proj_dim
    sampler_opt = lambda k, n, w, p: sample_laplace(k, lap_opt, n)
    sampler_real = lambda k, n, w, p: sample_laplace(k, lap_real, n)

    def sampler_bb(k, n, w, p):
        # refit a Laplace approximation to the current weighted coreset
        # (reference main.py:156-163); empty coreset -> prior N(0, I).
        # p.size is a trace-time constant, so the empty branch resolves at
        # compile time (an all-zero-weight coreset also yields the prior).
        if p.size == 0:
            return jax.random.normal(k, (n, dth))
        lap = laplace_approx(p, w, jnp.zeros(dth),
                             grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint, num_iters=20)
        eps = jax.random.normal(k, (n, dth), lap.mu.dtype)
        return lap.mu + eps @ lap.USig.T

    # warm-start variant for the SparseVI inner loop: each of the opt_itrs
    # Adam steps refits the Laplace approximation, but weights move little
    # per step, so Newton from the carried previous mode needs ~3 damped
    # iterations instead of 20 from zero (quadratic convergence tracking a
    # slowly-moving optimum).  init_carry (run once per build entry) does
    # the full-depth solve.
    def init_carry_bb(w, p):
        if p.size == 0:
            return jnp.zeros(dth)
        lap = laplace_approx(p, w, jnp.zeros(dth),
                             grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint, num_iters=25)
        return lap.mu

    def sampler_bb_warm(k, n, w, p, mode):
        if p.size == 0:
            return jax.random.normal(k, (n, dth)), mode
        lap = laplace_approx(p, w, mode,
                             grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint, num_iters=3)
        eps = jax.random.normal(k, (n, dth), lap.mu.dtype)
        return lap.mu + eps @ lap.USig.T, lap.mu

    sched = step_sched(arguments.step_sched)
    seed = arguments.trial

    def make_alg(name):
        if name == "SVI":
            return bc.SparseVICoreset(
                Z, bc.BlackBoxProjector(sampler_bb, S, model.log_likelihood,
                                        model.grad_z_log_likelihood,
                                        warm_sampler=sampler_bb_warm,
                                        init_carry=init_carry_bb),
                opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed,
                capacity=int(arguments.coreset_size_max))
        sd = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}[arguments.select_dtype]
        stream = getattr(arguments, "stream_chunk_size", 0) or None
        mesh = None
        if getattr(arguments, "data_mesh", 0):
            from ..parallel import make_mesh
            mesh = make_mesh({"data": int(arguments.data_mesh)})
        if name == "GIGA-OPT":
            return bc.HilbertCoreset(
                Z, bc.BlackBoxProjector(sampler_opt, S, model.log_likelihood), seed=seed,
                select_dtype=sd, stream_chunk_size=stream, mesh=mesh)
        if name == "GIGA-REAL":
            return bc.HilbertCoreset(
                Z, bc.BlackBoxProjector(sampler_real, S, model.log_likelihood), seed=seed,
                select_dtype=sd, stream_chunk_size=stream, mesh=mesh)
        if name == "US":
            return bc.UniformSamplingCoreset(Z, seed=seed)
        if name == "BPSVI":
            return bc.BatchPSVICoreset(
                Z, bc.BlackBoxProjector(sampler_bb, S, model.log_likelihood,
                                        model.grad_z_log_likelihood,
                                        warm_sampler=sampler_bb_warm,
                                        init_carry=init_carry_bb),
                opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed)
        raise ValueError(name)

    alg = make_alg(arguments.alg)

    nM = Ms.shape[0]
    cputs = np.zeros(nM)
    mcmc_time_per_itr = np.zeros(nM)
    csizes = np.zeros(nM)
    Fs = np.zeros(nM)
    rklw = np.zeros(nM)
    fklw = np.zeros(nM)
    mu_errs = np.zeros(nM)
    Sig_errs = np.zeros(nM)
    rhats = np.zeros(nM)
    esses = np.zeros(nM)

    # precompute full-data gradient sums over posterior samples for Fs
    # (reference main.py:226-228, vectorized instead of a python loop)
    ths = jnp.asarray(full_samples[: arguments.fs_samples], jnp.float32)
    gfs = np.asarray(model.grad_th_log_joint(Z, ths, jnp.ones(N)))

    t_alg = 0.0
    for m in range(nM):
        print(f"M = {Ms[m]}: coreset construction, {arguments.alg} "
              f"{arguments.dataset} {arguments.trial}")
        t0 = time.perf_counter()
        if arguments.alg == "BPSVI":
            alg.build(int(Ms[m]))       # size semantics (reference bpsvi.py:15-22)
        else:
            itrs = int(Ms[m] if m == 0 else Ms[m] - Ms[m - 1])
            alg.build(itrs)
        t_alg += time.perf_counter() - t0
        wts, pts, idcs = alg.get()

        print(f"M = {Ms[m]}: weighted NUTS on coreset")
        key, kmc = jax.random.split(key)
        if wts.shape[0] == 0:
            pts_m = np.zeros((1, dz), np.float32)
            wts_m = np.zeros(1, np.float32)
        else:
            pts_m, wts_m = np.asarray(pts, np.float32), np.asarray(wts, np.float32)
        # pad the coreset to a power-of-two bucket with zero weights: the
        # padded rows contribute exactly nothing to the log-density, and the
        # NUTS jit compiles once per bucket instead of once per size
        pad = 1 << int(np.ceil(np.log2(max(pts_m.shape[0], 8))))
        pts_m = np.vstack([pts_m, np.zeros((pad - pts_m.shape[0], dz), np.float32)])
        wts_m = np.concatenate([wts_m, np.zeros(pad - wts_m.shape[0], np.float32)])
        n_cst = -(-arguments.mcmc_samples_coreset // nc)
        cst_samples, t_cst, res_cst = mcmc.run(
            model, pts_m, wts_m, n_cst, kmc, d=dth, num_chains=nc,
            target_accept=arguments.target_accept, pooled_adaptation=nc > 1,
            num_warmup=arguments.mcmc_samples_coreset,
            max_depth=arguments.max_treedepth,
            dense_mass=arguments.dense_mass, mesh=mesh)
        cst_samples = np.asarray(cst_samples)
        rhats[m], esses[m] = chain_diagnostics(res_cst)
        if unconverged(rhats[m], esses[m], arguments.ess_gate) \
                and not arguments.dense_mass:
            # retry with the dense (d, d) metric (residual posterior
            # correlation the diagonal cannot equalize)
            print(f"M = {Ms[m]}: coreset chains unconverged "
                  f"(split-R-hat {rhats[m]:.3f}, min ESS {esses[m]:.0f}); "
                  f"retrying with dense mass matrix")
            key, kmc2 = jax.random.split(key)
            cst_samples, t_cst, res_cst = mcmc.run(
                model, pts_m, wts_m, n_cst, kmc2, d=dth, num_chains=nc,
                target_accept=arguments.target_accept,
                pooled_adaptation=nc > 1,
                num_warmup=arguments.mcmc_samples_coreset,
                max_depth=arguments.max_treedepth,
                dense_mass=True, mesh=mesh)
            cst_samples = np.asarray(cst_samples)
            rhats[m], esses[m] = chain_diagnostics(res_cst)
        if unconverged(rhats[m], esses[m], arguments.ess_gate):
            print(f"WARNING: coreset chains at M={Ms[m]} not converged "
                  f"(max split-R-hat {rhats[m]:.3f} > {RHAT_GATE} or "
                  f"min ESS {esses[m]:.0f} < {arguments.ess_gate})")

        muw = cst_samples.mean(axis=0)
        Sigw = np.cov(cst_samples, rowvar=False)

        cputs[m] = t_alg
        mcmc_time_per_itr[m] = t_cst / (nc * n_cst * 2)
        csizes[m] = (wts_m > 0).sum()
        gcs = np.asarray(model.grad_th_log_joint(jnp.asarray(pts_m), ths,
                                                 jnp.asarray(wts_m)))
        Fs[m] = (((gcs - gfs) ** 2).sum(axis=1)).mean()
        # quality metrics in f64 on host: the small-KL tail (rKL < 1e-2,
        # exactly where parity is judged) underflows in f32 trace/logdet
        # cancellation (see models/gaussian.kl_divergence_np)
        rklw[m] = float(kl_divergence_np(muw, Sigw, mup, SigpInv))
        fklw[m] = float(kl_divergence_np(mup, Sigp, muw, np.linalg.inv(
            np.asarray(Sigw, np.float64))))
        mu_errs[m] = np.linalg.norm(mup - muw) / np.linalg.norm(mup)
        Sig_errs[m] = np.linalg.norm(Sigp - Sigw) / np.linalg.norm(Sigp)
        print(f"M = {Ms[m]}: rkl={rklw[m]:.4f} fkl={fklw[m]:.4f} Fs={Fs[m]:.3e} "
              f"rhat={rhats[m]:.3f} minESS={esses[m]:.0f}")

    results.save(arguments, csizes=csizes, Ms=Ms, cputs=cputs, Fs=Fs,
                 full_mcmc_time_per_itr=np.full(nM, full_mcmc_time_per_itr),
                 mcmc_time_per_itr=mcmc_time_per_itr, rklw=rklw, fklw=fklw,
                 mu_errs=mu_errs, Sig_errs=Sig_errs, rhats=rhats, esses=esses,
                 full_rhat=np.full(nM, full_rhat), full_ess=np.full(nM, full_ess))


def main(argv=None):
    parser, run_p, _ = make_parser(
        "Logistic/Poisson regression coreset experiment with weighted NUTS")
    run_p.set_defaults(func=run)
    parser.add_argument("--model", choices=["lr", "poiss"], default="lr")
    parser.add_argument("--dataset", type=str, default="synth_lr")
    parser.add_argument("--alg", type=str, default="GIGA-OPT", choices=ALGS)
    parser.add_argument("--mcmc_samples_full", type=int, default=10000)
    parser.add_argument("--mcmc_samples_coreset", type=int, default=10000)
    parser.add_argument("--mcmc_chains", type=int, default=8,
                        help="vmapped NUTS chains (pooled adaptation when >1); "
                             "chain parallelism is the accelerator's "
                             "throughput lever")
    parser.add_argument("--target_accept", type=float, default=0.9,
                        help="NUTS acceptance target (Stan adapt_delta)")
    parser.add_argument("--dense_mass", action="store_true",
                        help="adapt a full (d, d) covariance metric (Stan's "
                             "dense_e) — for correlated posteriors a diagonal "
                             "cannot equalize (e.g. airportdelays); without "
                             "this flag the driver still auto-retries "
                             "unconverged coreset chains with dense_e")
    parser.add_argument("--ess_gate", type=float, default=ESS_GATE,
                        help="min bulk-ESS (over dims, all chains pooled) a "
                             "run must reach before its metrics are recorded; "
                             "failing runs retry like an R-hat failure")
    parser.add_argument("--data_mesh", type=int, default=0,
                        help="(GIGA-*) shard dataset rows over this many "
                             "devices (shard_map SPMD build; composes with "
                             "--stream_chunk_size)")
    parser.add_argument("--chain_mesh", action="store_true",
                        help="shard NUTS chains over all visible devices via "
                             "the chain mesh (parallel/mcmc.py); chains round "
                             "up to a multiple of the device count")
    parser.add_argument("--max_treedepth", type=int, default=15,
                        help="NUTS max tree depth (reference control "
                             "max_treedepth=15, mcmc.py:58)")
    parser.add_argument("--proj_dim", type=int, default=500)
    parser.add_argument("--fs_samples", type=int, default=1000,
                        help="posterior samples used for the Fs metric")
    parser.add_argument("--coreset_size_max", type=int, default=1000)
    parser.add_argument("--coreset_num_sizes", type=int, default=7)
    parser.add_argument("--coreset_size_spacing", choices=["log", "linear"], default="log")
    parser.add_argument("--opt_itrs", type=int, default=100)
    parser.add_argument("--step_sched", type=str, default="inv")
    parser.add_argument("--select_dtype", choices=["f32", "bf16", "int8"], default="f32",
                        help="reduced-precision selection copy for Hilbert solvers")
    parser.add_argument("--stream_chunk_size", type=int, default=0,
                        help="(GIGA-*) chunked projection with int8-resident "
                             "storage: beyond-HBM datasets on one chip")
    arguments = parser.parse_args(argv)
    if not hasattr(arguments, "func"):
        parser.error("specify a subcommand: run | plot")
    arguments.func(arguments)


if __name__ == "__main__":
    main()
