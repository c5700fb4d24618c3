"""Synthetic multivariate-Gaussian coreset experiment.

Driver with the capability surface of the reference's
``examples/gaussian/main.py``: seven algorithms (SparseVI exact/black-box,
GIGA with optimal/realistic/exact projectors, uniform sampling), incremental
builds over a log-spaced size grid, closed-form posterior quality metrics
(reverse/forward KL, relative mean/cov errors), and the results store.

Run:  python -m bayesian_coresets_tpu.experiments.gaussian run --alg GIGA-OPT --trial 1
Plot: python -m bayesian_coresets_tpu.experiments.gaussian plot Ms rklw --plot_legend alg
"""

from __future__ import annotations

import pickle
import os
import time

import numpy as np

from .. import coresets as bc
from ..models import gaussian
from ..utils import prng, set_verbosity
from . import results
from .cli import coreset_size_grid, make_parser, step_sched


def run(arguments):
    import jax
    import jax.numpy as jnp

    if results.check_exists(arguments):
        print(f"Results already exist for arguments {arguments}\nQuitting.")
        return
    set_verbosity(arguments.verbosity)

    Ms = coreset_size_grid(arguments.coreset_size_max, arguments.coreset_num_sizes,
                           arguments.coreset_size_spacing)
    d = arguments.data_dim
    N = arguments.data_num
    S = arguments.proj_dim

    # prior/likelihood setup (reference gaussian/main.py:62-75)
    mu0 = jnp.zeros(d)
    Sig0inv = jnp.eye(d)
    Siginv = jnp.eye(d)
    LSigInv = jnp.eye(d)    # chol(Siginv)
    logdetSig = 0.0

    key = prng.fold_seed(arguments.trial)
    kdata, khat, kprj = jax.random.split(key, 3)
    x = gaussian.gen_synthetic(kdata, N, d)

    post = gaussian.weighted_post(mu0, Sig0inv, Siginv, x, jnp.ones(N))
    Sigp = np.asarray(post.USig @ post.USig.T)
    SigpInv = np.asarray(post.LSigInv @ post.LSigInv.T)
    mup = np.asarray(post.mu)

    loglik = lambda pts, th: gaussian.log_likelihood(pts, th, Siginv, logdetSig)
    gradll = lambda pts, th: gaussian.grad_x_log_likelihood(pts, th, Siginv)

    # samplers (reference gaussian/main.py:96-113)
    def sampler_optimal(k, n, wts, pts):
        return gaussian.sample_weighted_post(k, mu0, Sig0inv, Siginv, x, jnp.ones(N), n)

    xhat = x[jax.random.randint(khat, (int(np.sqrt(N)),), 0, N)]

    def sampler_realistic(k, n, wts, pts):
        return gaussian.sample_weighted_post(k, mu0, Sig0inv, Siginv, xhat,
                                             jnp.ones(xhat.shape[0]), n)

    # SparseVI/BPSVI call this on every Adam step; the precomputed joint
    # diagonalization keeps each refit factorization-free (O(d^2) matmuls).
    post_basis = jax.jit(gaussian.posterior_basis)(mu0, Sig0inv, Siginv)

    def sampler_bb(k, n, wts, pts):
        if pts.size == 0:
            wts = jnp.zeros(1)
            pts = jnp.zeros((1, d))
        return gaussian.sample_weighted_post_basis(k, post_basis, pts, wts, n)

    exact_family = bc.gaussian_tangent_family(mu0, Sig0inv, Siginv, LSigInv)
    sched = step_sched(arguments.step_sched)
    seed = arguments.trial

    stream = getattr(arguments, "stream_chunk_size", None) or None
    mesh = None
    if getattr(arguments, "data_mesh", 0):
        from ..parallel import make_mesh
        mesh = make_mesh({"data": int(arguments.data_mesh)})

    def make_alg(name):
        cap = int(arguments.coreset_size_max)   # compile once for the sweep
        if name == "SVI-EXACT":
            return bc.SparseVICoreset(x, exact_family, opt_itrs=arguments.opt_itrs,
                                      step_sched=sched, seed=seed, capacity=cap)
        if name == "SVI":
            return bc.SparseVICoreset(
                x, bc.BlackBoxProjector(sampler_bb, S, loglik, gradll),
                opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed,
                capacity=cap)
        sd = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}[arguments.select_dtype]
        if name == "GIGA-OPT":
            return bc.HilbertCoreset(
                x, bc.BlackBoxProjector(sampler_optimal, S, loglik, gradll), seed=seed,
                select_dtype=sd, stream_chunk_size=stream, mesh=mesh)
        if name == "GIGA-OPT-EXACT":
            prj = bc.FamilyProjector(exact_family)
            prj.update(jnp.ones(N), x)
            return bc.HilbertCoreset(x, prj, seed=seed)
        if name == "GIGA-REAL":
            return bc.HilbertCoreset(
                x, bc.BlackBoxProjector(sampler_realistic, S, loglik, gradll), seed=seed)
        if name == "GIGA-REAL-EXACT":
            prj = bc.FamilyProjector(exact_family)
            prj.update(jnp.ones(xhat.shape[0]), xhat)
            return bc.HilbertCoreset(x, prj, seed=seed)
        if name == "US":
            return bc.UniformSamplingCoreset(x, seed=seed)
        if name == "BPSVI":
            return bc.BatchPSVICoreset(
                x, bc.BlackBoxProjector(sampler_bb, S, loglik, gradll),
                opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed)
        raise ValueError(name)

    alg = make_alg(arguments.alg)

    print("Building coreset")
    w, p = [], []
    cputs = np.zeros(Ms.shape[0])
    t_build = 0.0
    for m in range(Ms.shape[0]):
        print(f"M = {Ms[m]}: coreset construction, {arguments.alg} {arguments.trial}")
        t0 = time.perf_counter()
        if arguments.alg == "BPSVI":
            # pseudocoreset build() takes the SIZE and re-initializes
            # (reference bpsvi.py:15-22), so each grid point is a fresh build
            alg.build(int(Ms[m]))
        else:
            itrs = int(Ms[m] if m == 0 else Ms[m] - Ms[m - 1])
            alg.build(itrs)
        t_build += time.perf_counter() - t0
        wts, pts, idcs = alg.get()
        w.append(wts)
        p.append(pts)
        cputs[m] = t_build

    # metrics (reference gaussian/main.py:195-207)
    csizes = np.zeros(Ms.shape[0])
    rklw = np.zeros(Ms.shape[0])
    fklw = np.zeros(Ms.shape[0])
    mu_errs = np.zeros(Ms.shape[0])
    Sig_errs = np.zeros(Ms.shape[0])
    muw = np.zeros((Ms.shape[0], d))
    Sigw = np.zeros((Ms.shape[0], d, d))
    for m in range(Ms.shape[0]):
        csizes[m] = (w[m] > 0).sum()
        pts_m = jnp.asarray(np.atleast_2d(np.asarray(p[m], np.float32)))
        wts_m = jnp.asarray(np.asarray(w[m], np.float32))
        wp = gaussian.weighted_post(mu0, Sig0inv, Siginv, pts_m, wts_m)
        muw[m] = np.asarray(wp.mu)
        Sigw[m] = np.asarray(wp.USig @ wp.USig.T)
        # f64 host metrics: the small-KL tail (rKL < 1e-2, where parity is
        # judged) is corrupted by f32 trace/logdet cancellation — same fix
        # as the linreg driver (models/gaussian.kl_divergence_np)
        rklw[m] = float(gaussian.kl_divergence_np(muw[m], Sigw[m], mup, SigpInv))
        fklw[m] = float(gaussian.kl_divergence_np(
            mup, Sigp, muw[m], np.asarray(wp.LSigInv @ wp.LSigInv.T)))
        mu_errs[m] = np.linalg.norm(mup - muw[m]) / np.linalg.norm(mup)
        Sig_errs[m] = np.linalg.norm(Sigp - Sigw[m]) / np.linalg.norm(Sigp)

    results.save(arguments, csizes=csizes, Ms=Ms, cputs=cputs, rklw=rklw,
                 fklw=fklw, mu_errs=mu_errs, Sig_errs=Sig_errs)

    # raw coreset dump for visualization (reference gaussian/main.py:210-215)
    os.makedirs(arguments.results_folder, exist_ok=True)
    with open(os.path.join(arguments.results_folder, "coreset_data.pk"), "wb") as f:
        pickle.dump((np.asarray(x), np.asarray(mu0), np.eye(d), np.eye(d),
                     mup, Sigp, w, p, muw, Sigw), f)


ALGS = ["SVI", "SVI-EXACT", "GIGA-OPT", "GIGA-OPT-EXACT", "GIGA-REAL",
        "GIGA-REAL-EXACT", "US", "BPSVI"]


def main(argv=None):
    parser, run_p, _ = make_parser("Gaussian KL coreset experiment")
    run_p.set_defaults(func=run)
    parser.add_argument("--data_num", type=int, default=1000)
    parser.add_argument("--data_dim", type=int, default=200)
    parser.add_argument("--alg", type=str, default="GIGA-OPT", choices=ALGS)
    parser.add_argument("--proj_dim", type=int, default=100)
    parser.add_argument("--coreset_size_max", type=int, default=200)
    parser.add_argument("--coreset_num_sizes", type=int, default=7)
    parser.add_argument("--coreset_size_spacing", choices=["log", "linear"], default="log")
    parser.add_argument("--opt_itrs", type=int, default=100)
    parser.add_argument("--step_sched", type=str, default="inv")
    parser.add_argument("--select_dtype", choices=["f32", "bf16", "int8"], default="f32",
                        help="reduced-precision selection copy for Hilbert solvers")
    parser.add_argument("--stream_chunk_size", type=int, default=0,
                        help="(GIGA-OPT) chunked projection with int8-resident "
                             "storage: beyond-HBM datasets on one chip")
    parser.add_argument("--data_mesh", type=int, default=0,
                        help="(GIGA-OPT) shard dataset rows over this many "
                             "devices (shard_map SPMD build; composes with "
                             "--stream_chunk_size for sharded-streamed "
                             "beyond-HBM construction)")
    arguments = parser.parse_args(argv)
    if not hasattr(arguments, "func"):
        parser.error("specify a subcommand: run | plot")
    arguments.func(arguments)


if __name__ == "__main__":
    main()
