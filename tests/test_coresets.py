"""Coreset-layer end-to-end tests on the conjugate Gaussian model.

The closed-form weighted posterior (reference model_gaussian.py:23-30) gives
exact quality metrics with zero MCMC noise — the same strategy as the
reference's gaussian driver (examples/gaussian/main.py:200-207).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bayesian_coresets_tpu as bct
from bayesian_coresets_tpu.models import gaussian
from bayesian_coresets_tpu.ops import GIGA, FrankWolfe


@pytest.fixture(scope="module")
def gauss_setup():
    d, N, S = 10, 400, 100
    x = gaussian.gen_synthetic(jax.random.key(1), N, d)
    mu0 = jnp.zeros(d)
    Sig0inv = jnp.eye(d)
    Siginv = jnp.eye(d)
    post = gaussian.weighted_post(mu0, Sig0inv, Siginv, x, jnp.ones(N))
    SigpInv = np.asarray(post.LSigInv @ post.LSigInv.T)

    loglik = lambda pts, th: gaussian.log_likelihood(pts, th, Siginv, 0.0)
    gradll = lambda pts, th: gaussian.grad_x_log_likelihood(pts, th, Siginv)

    def sampler_opt(k, n, wts, pts):
        return gaussian.sample_weighted_post(k, mu0, Sig0inv, Siginv, x, jnp.ones(N), n)

    def sampler_bb(k, n, wts, pts):
        if pts.size == 0:
            wts = jnp.zeros(1)
            pts = jnp.zeros((1, d))
        return gaussian.sample_weighted_post(k, mu0, Sig0inv, Siginv, pts, wts, n)

    def rkl(wts, pts):
        wp = gaussian.weighted_post(mu0, Sig0inv, Siginv,
                                    jnp.asarray(np.atleast_2d(np.asarray(pts, np.float32))),
                                    jnp.asarray(np.asarray(wts, np.float32)))
        return float(gaussian.kl_divergence(wp.mu, wp.USig @ wp.USig.T, post.mu, SigpInv))

    return dict(x=x, d=d, N=N, S=S, loglik=loglik, gradll=gradll,
                sampler_opt=sampler_opt, sampler_bb=sampler_bb, rkl=rkl)


class TestHilbert:
    def test_giga_quality_improves(self, gauss_setup):
        g = gauss_setup
        hc = bct.HilbertCoreset(g["x"], bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"]))
        kls = []
        prev = 0
        for M in [10, 50, 150]:
            hc.build(M - prev)
            prev = M
            w, p, i = hc.get()
            assert (w > 0).all()
            assert hc.size() <= M
            kls.append(g["rkl"](w, p))
        assert kls[-1] < kls[0] / 100.0
        assert kls[-1] < 0.1

    def test_subsampled(self, gauss_setup):
        g = gauss_setup
        hc = bct.HilbertCoreset(g["x"], bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"]),
                                n_subsample=200)
        hc.build(100)
        w, p, i = hc.get()
        # quality floor is set by the subsample, not the solver; just require
        # a big improvement over the empty coreset (rkl ~ O(100))
        assert g["rkl"](w, p) < 20.0
        assert np.unique(i).shape[0] == i.shape[0]  # no duplicate data indices

    def test_pluggable_solver(self, gauss_setup):
        g = gauss_setup
        hc = bct.HilbertCoreset(g["x"], bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"]),
                                snnls=FrankWolfe)
        hc.build(100)
        w, p, i = hc.get()
        assert g["rkl"](w, p) < 5.0

    def test_optimize_improves_or_keeps_error(self, gauss_setup):
        g = gauss_setup
        hc = bct.HilbertCoreset(g["x"], bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"]))
        hc.build(60)
        e = hc.error()
        hc.optimize()
        assert hc.error() <= e * (1 + 1e-4)

    def test_reset(self, gauss_setup):
        g = gauss_setup
        hc = bct.HilbertCoreset(g["x"], bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"]))
        hc.build(20)
        hc.reset()
        assert hc.size() == 0
        w, p, i = hc.get()
        assert w.shape[0] == 0


class TestSparseVI:
    def test_build_and_quality(self, gauss_setup):
        g = gauss_setup
        svi = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                                  opt_itrs=30)
        svi.build(10)
        w, p, i = svi.get()
        assert svi.size() <= 10
        assert (w >= 0).all()
        assert g["rkl"](w, p) < 100.0
        svi.build(10)
        assert svi.size() <= 20

    def test_subsampled_select(self, gauss_setup):
        g = gauss_setup
        svi = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                                  n_subsample_select=100, n_subsample_opt=100, opt_itrs=20)
        svi.build(5)
        assert svi.size() <= 5

    def test_unique_indices(self, gauss_setup):
        g = gauss_setup
        svi = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                                  opt_itrs=10)
        svi.build(15)
        assert np.unique(svi.idcs).shape[0] == svi.idcs.shape[0]


class TestBPSVI:
    def test_build_and_quality(self, gauss_setup):
        g = gauss_setup
        bp = bct.BatchPSVICoreset(
            g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"], g["gradll"]),
            opt_itrs=60)
        bp.build(10)
        w, p, i = bp.get()
        assert w.shape[0] == 10
        assert (w >= 0).all()
        assert (i == -1).all()  # synthetic points
        assert g["rkl"](w, p) < 30.0

    def test_requires_grad(self, gauss_setup):
        g = gauss_setup
        with pytest.raises(ValueError):
            bct.BatchPSVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                                 opt_itrs=10)

    def test_error_estimate(self, gauss_setup):
        g = gauss_setup
        bp = bct.BatchPSVICoreset(
            g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"], g["gradll"]),
            opt_itrs=60)
        assert bp.error() == 0.0          # empty pseudocoreset
        bp.build(10)
        e10 = bp.error()
        assert np.isfinite(e10) and e10 > 0.0
        # an optimized pseudocoreset must beat an unoptimized one of the
        # same size (fresh init, zero Adam steps)
        bp_raw = bct.BatchPSVICoreset(
            g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"], g["gradll"]),
            opt_itrs=0)
        bp_raw.build(10)
        assert e10 < bp_raw.error()


class TestUniform:
    def test_weights_sum(self, gauss_setup):
        g = gauss_setup
        us = bct.UniformSamplingCoreset(g["x"])
        us.build(50)
        w, p, i = us.get()
        np.testing.assert_allclose(w.sum(), g["N"], rtol=1e-6)
        us.build(50)
        w2, _, _ = us.get()
        np.testing.assert_allclose(w2.sum(), g["N"], rtol=1e-6)


class TestExactFamilies:
    def test_gaussian_exact_matches_blackbox_limit(self, gauss_setup):
        # exact tangent features must reproduce the Hilbert inner products the
        # black-box projector only estimates: compare residual-norm trajectories
        import jax
        import jax.numpy as jnp
        from bayesian_coresets_tpu.coresets import FamilyProjector, gaussian_tangent_family
        g = gauss_setup
        d = g["d"]
        fam = gaussian_tangent_family(jnp.zeros(d), jnp.eye(d), jnp.eye(d), jnp.eye(d))
        prj = FamilyProjector(fam)
        prj.update(jnp.ones(g["N"]), g["x"])
        hc = bct.HilbertCoreset(g["x"], prj)
        hc.build(100)
        w, p, i = hc.get()
        # exact projector should reach at least black-box quality
        assert g["rkl"](w, p) < 0.5

    def test_exact_features_inner_products(self):
        # <feat_i, feat_j>/dim should equal the exact tangent-space inner
        # product; verify against a huge-S Monte-Carlo black-box estimate
        import jax
        import jax.numpy as jnp
        from bayesian_coresets_tpu.coresets import gaussian_tangent_family, center_lls
        from bayesian_coresets_tpu.models import gaussian
        d, n, S = 3, 6, 200_000
        key = jax.random.key(0)
        x = gaussian.gen_synthetic(key, n, d)
        mu0, I = jnp.zeros(d), jnp.eye(d)
        fam = gaussian_tangent_family(mu0, I, I, I)
        ctx = fam.make_ctx(key, jnp.ones(n), x)
        feats = np.asarray(fam.project(ctx, x))          # (n, d+1)
        exact = feats @ feats.T / feats.shape[1]
        # black-box MC estimate under the same posterior
        samples = gaussian.sample_weighted_post(jax.random.key(1), mu0, I, I, x,
                                                jnp.ones(n), S)
        lls = np.asarray(center_lls(gaussian.log_likelihood(x, samples, I, 0.0)))
        mc = lls @ lls.T / S
        np.testing.assert_allclose(exact, mc, rtol=0.05, atol=0.05 * np.abs(mc).max())


class TestSVIErrorEstimate:
    def test_error_decreases_with_size(self, gauss_setup):
        g = gauss_setup
        svi = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                                  opt_itrs=20)
        assert svi.error() == 0.0     # empty coreset
        svi.build(3)
        e3 = svi.error()
        svi.build(12)
        e15 = svi.error()
        assert np.isfinite(e3) and np.isfinite(e15)
        assert e15 < e3               # residual shrinks as the coreset grows
        svi.optimize()                # must not latch on MC noise
        assert not svi.reached_numeric_limit


class TestStreamedHilbert:
    """int8-resident (beyond-HBM) construction: chunked projection with
    on-chip quantization (stream_chunk_size)."""

    def test_streamed_matches_inmemory_quality(self, gauss_setup):
        g = gauss_setup
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        hs = bct.HilbertCoreset(g["x"], prj, stream_chunk_size=128)  # 400 -> 4 chunks, last padded
        hs.build(100)
        w, p, i = hs.get()
        assert (w >= 0).all()
        assert i.max() < g["N"] and i.min() >= 0
        assert g["rkl"](w, p) < 1.0
        # incremental build continues
        hs.build(50)
        assert hs.error() >= 0.0

    def test_streamed_sharded_matches_single_device(self, gauss_setup):
        """mesh= streams quantized chunks directly into per-device row
        shards (no host/single-device full copy) and runs the shard_map
        SPMD build: quantized consts must equal the single-device stream's,
        and the build must match an unsharded solver on the same consts."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from bayesian_coresets_tpu.ops import snnls as S
        from bayesian_coresets_tpu.parallel import make_mesh

        g = gauss_setup
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        mesh = make_mesh({"data": 8})
        hs = bct.HilbertCoreset(g["x"], prj, stream_chunk_size=64, mesh=mesh)
        consts = hs.snnls.consts
        assert consts.V.sharding.spec == P("data", None)

        # same quantization as direct on-host projection.  Quantization is
        # row-local, but the projection itself is compiled INTO the
        # per-shard program (SPMD on-device projection), so XLA fusion may
        # shift last-ulp values across the int8 round boundary: allow a
        # +-1 step difference at a vanishing fraction of entries
        vecs = np.asarray(prj.project(g["x"]))
        norms = np.sqrt((vecs**2).sum(axis=1))
        safe = np.where(norms > 0, norms, 1.0)
        Vq = np.clip(np.round(vecs / safe[:, None] * 127.0), -127, 127).astype(np.int8)
        N = g["N"]
        got = np.asarray(consts.V)[:N, :g["S"]]
        diff = np.abs(got.astype(np.int32) - Vq.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(consts.norms)[:N], norms, rtol=1e-5)
        assert not np.asarray(consts.valid)[N:].any()

        # sharded build == unsharded build on the SAME consts (50 iters:
        # below the REFRESH_EVERY boundary where the sharded dense refresh
        # legitimately reorders the quantized matvec sum)
        hs.build(50)
        host = S.make_consts_quantized(
            jnp.asarray(np.asarray(consts.V)), jnp.asarray(np.asarray(consts.norms)),
            jnp.asarray(np.asarray(consts.b)), valid=jnp.asarray(np.asarray(consts.valid)))
        alg = S.GIGA.from_consts(host, max_active=hs.snnls._max_active)
        alg.build(50)
        i1, v1 = hs.snnls.active()
        i2, v2 = alg.active()
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-7)

        # quality end-to-end + the sharded FISTA optimize path
        hs.build(50)
        w, p, i = hs.get()
        assert g["rkl"](w, p) < 1.0
        e0 = hs.error()
        hs.optimize()
        assert hs.error() <= e0 * (1.0 + 1e-5)

    def test_inmemory_mesh_matches_single_device(self, gauss_setup):
        """HilbertCoreset(mesh=...) without streaming: the projected system
        is padded + row-sharded and every facade operation runs through the
        shard_map SPMD path — f32 results bit-match the unsharded build."""
        from bayesian_coresets_tpu.parallel import make_mesh

        g = gauss_setup
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        mesh = make_mesh({"data": 8})
        hm = bct.HilbertCoreset(g["x"], prj, seed=0, mesh=mesh)
        h1 = bct.HilbertCoreset(g["x"], prj, seed=0)
        # identical projections require identical sampler draws: both
        # projectors are keyed identically (seed-deterministic), so the
        # solver inputs match and results must be bitwise equal
        hm.build(60)
        h1.build(60)
        np.testing.assert_array_equal(hm.idcs, h1.idcs)
        np.testing.assert_array_equal(np.asarray(hm.wts), np.asarray(h1.wts))
        e0 = hm.error()
        hm.optimize()
        assert hm.error() <= e0 * (1.0 + 1e-5)

    def test_streamed_sharded_spmd_vs_hostproj_fallback(self, gauss_setup):
        """jax-traceable projectors project ON their owner shard inside
        shard_map (mode 'spmd'); a projector with numpy internals falls
        back to default-device projection + int8 shipping ('hostproj')
        with equivalent results."""
        from bayesian_coresets_tpu.parallel import make_mesh

        g = gauss_setup
        mesh = make_mesh({"data": 8})
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        hs = bct.HilbertCoreset(g["x"], prj, stream_chunk_size=64, mesh=mesh)
        assert hs.streamed_sharded_mode == "spmd"

        class NumpyProjector:
            """Fixed-context projector that computes in numpy."""

            def __init__(self, inner):
                self.inner = inner

            def project(self, pts):
                out = self.inner.project(jnp.asarray(np.asarray(pts)))
                return jnp.asarray(np.asarray(out))     # forces a host trip

            def update(self, wts, pts):
                pass

        hp = bct.HilbertCoreset(g["x"], NumpyProjector(prj),
                                stream_chunk_size=64, mesh=mesh)
        assert hp.streamed_sharded_mode == "hostproj"
        # hostproj projects with the same eager program as the direct
        # host quantization -> its int8 rows are bitwise equal to it
        vecs = np.asarray(prj.project(g["x"]))
        norms = np.sqrt((vecs**2).sum(axis=1))
        safe = np.where(norms > 0, norms, 1.0)
        Vq = np.clip(np.round(vecs / safe[:, None] * 127.0),
                     -127, 127).astype(np.int8)
        N = g["N"]
        np.testing.assert_array_equal(
            np.asarray(hp.snnls.consts.V)[:N, :g["S"]], Vq)
        # both paths build equivalent-quality coresets from the same
        # tangent context (spmd may differ by one int8 ulp at a handful
        # of round-boundary entries, so demand quality, not bit equality)
        hs.build(40)
        hp.build(40)
        assert g["rkl"](*hs.get()[:2]) < 1.0
        assert g["rkl"](*hp.get()[:2]) < 1.0

    def test_streamed_sharded_catches_shard_unsafe_projector(self, gauss_setup):
        """A jax-traceable projector whose output depends on the batch
        SHAPE (a realistic shard_map hazard: per-device chunks see local
        batch sizes) passes the trace-error fallback, but the probe-row
        cross-check catches the divergence and reroutes to the hostproj
        path, which reproduces single-device streaming semantics."""
        from bayesian_coresets_tpu.parallel import make_mesh

        g = gauss_setup
        mesh = make_mesh({"data": 8})
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])

        class BatchScaledProjector:
            """Deterministic + traceable, but scales by the batch size —
            wrong under shard_map, where each device sees a local batch."""

            def __init__(self, inner):
                self.inner = inner

            def project(self, pts):
                return self.inner.project(pts) * pts.shape[0]

            def update(self, wts, pts):
                pass

        hb = bct.HilbertCoreset(g["x"], BatchScaledProjector(prj),
                                stream_chunk_size=64, mesh=mesh)
        assert hb.streamed_sharded_mode == "hostproj"
        # the committed rows came from the (consistent) default-device
        # stream: per-row normalization cancels the batch scale, so the
        # int8 rows must match the direct quantization of the projection
        vecs = np.asarray(prj.project(g["x"]))
        norms = np.sqrt((vecs**2).sum(axis=1))
        safe = np.where(norms > 0, norms, 1.0)
        Vq = np.clip(np.round(vecs / safe[:, None] * 127.0),
                     -127, 127).astype(np.int8)
        np.testing.assert_array_equal(
            np.asarray(hb.snnls.consts.V)[:g["N"], :g["S"]], Vq)

    def test_streamed_rejects_subsample(self, gauss_setup):
        g = gauss_setup
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        with pytest.raises(ValueError):
            bct.HilbertCoreset(g["x"], prj, n_subsample=100, stream_chunk_size=128)

    def test_streamed_quantization_matches_direct(self, gauss_setup):
        """The streamed int8 rows / norms / b must equal direct on-host
        quantization of the full projection (same projector ctx)."""
        g = gauss_setup
        prj = bct.BlackBoxProjector(g["sampler_opt"], g["S"], g["loglik"])
        hs = bct.HilbertCoreset(g["x"], prj, stream_chunk_size=128)
        consts = hs.snnls.consts
        vecs = np.asarray(prj.project(g["x"]))
        norms = np.sqrt((vecs**2).sum(axis=1))
        safe = np.where(norms > 0, norms, 1.0)
        Vq = np.clip(np.round(vecs / safe[:, None] * 127.0), -127, 127).astype(np.int8)
        N = g["N"]
        np.testing.assert_array_equal(np.asarray(consts.V)[:N, :g["S"]], Vq)
        np.testing.assert_allclose(np.asarray(consts.norms)[:N], norms, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(consts.b)[:g["S"]], vecs.sum(axis=0),
                                   rtol=1e-4, atol=1e-3)
        assert not np.asarray(consts.valid)[N:].any()


def test_sparsevi_optimize_crn_checked(gauss_setup):
    """optimize() restores the base-class rollback contract via common
    random numbers: a healthy re-opt never latches (the CRN before/after
    estimates share their sampling noise), while an optimize that genuinely
    worsens the objective is rolled back and latches the numeric limit."""
    g = gauss_setup
    a = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                            opt_itrs=20, seed=1, capacity=16)
    a.build(8)
    wts_before = a.wts.copy()
    a.optimize()
    assert not a.reached_numeric_limit          # no spurious noise rollback
    assert a.size() > 0

    # force a genuinely-worsening "optimization": corrupt the weights
    b = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                            opt_itrs=20, seed=1, capacity=16)
    b.build(8)
    good = np.asarray(b.wts).copy()

    def corrupt():
        b._wts = b._wts.at[:].multiply(50.0)
        b._sync()

    b._optimize = corrupt
    b.optimize()
    assert b.reached_numeric_limit              # rolled back + latched
    np.testing.assert_allclose(b.wts, good, rtol=1e-6)
    del wts_before


def test_sparsevi_capacity_hint(gauss_setup):
    """capacity= preallocates slots (one compile per sweep); results must
    be identical to the default growth path given the same seed."""
    g = gauss_setup
    a = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                            opt_itrs=10, seed=3, capacity=16)
    assert a._cap == 16
    a.build(5)
    a.build(5)
    assert a.size() <= 10
    b = bct.SparseVICoreset(g["x"], bct.BlackBoxProjector(g["sampler_bb"], g["S"], g["loglik"]),
                            opt_itrs=10, seed=3)
    b.build(5)
    b.build(5)
    np.testing.assert_array_equal(a.idcs, b.idcs)
    a.reset()
    assert a._cap == 16 and a.size() == 0


@pytest.mark.parametrize("stream", [False, True])
def test_hilbert_masks_rows_below_float32_floor(stream):
    """A row far below eps * ||b|| (a saturated point's projection) stays
    in the target b but is never a candidate: GIGA would weight it by
    ~1/norm.  Rows above the floor stay selectable."""
    from bayesian_coresets_tpu.coresets import (FamilyProjector,
                                                identity_tangent_family)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    x[5] = 1e-9 * x.sum(axis=0)           # aligned with b, norm ~ 1e-8
    x[7] = 1e-3 * x.sum(axis=0)           # small but above the floor
    kw = {"stream_chunk_size": 32} if stream else {}
    c = bct.HilbertCoreset(x, FamilyProjector(identity_tangent_family()), **kw)
    valid = np.asarray(c.snnls.consts.valid)[:64]
    assert not valid[5] and valid[7] and valid.sum() == 63
    b = np.asarray(c.snnls.consts.b)[:16]
    np.testing.assert_allclose(b, x.sum(axis=0), rtol=1e-5, atol=1e-5)
    c.build(10)
    assert 5 not in set(c.get()[2].tolist())


def test_norm_floor_does_not_grow_with_coherent_rows():
    """Coherent rows (||b|| ~ N x the mean row norm) at N = 2^24: eps*||b||
    alone would exceed every row's norm; the floor stays a fraction of the
    mean row norm, so every ordinary row stays selectable while a row far
    below float32 resolution of the rows is still masked."""
    from bayesian_coresets_tpu.ops.snnls import above_norm_floor
    N = 1 << 24
    norms = np.random.default_rng(0).uniform(0.5, 1.5, N).astype(np.float32)
    norms[7] = 1e-6
    bnorm = 0.9 * float(norms.sum(dtype=np.float64))   # nearly aligned rows
    assert np.finfo(np.float32).eps * bnorm > norms.max()
    keep = above_norm_floor(norms, bnorm)
    assert not keep[7] and keep.sum() == N - 1


def test_norm_floor_incoherent_target_masks_below_eps_b():
    """A Laplace-like tangent space: ||b|| is small next to the sum of row
    norms, so the eps*||b|| floor decides, independent of the row mean."""
    from bayesian_coresets_tpu.ops.snnls import above_norm_floor
    eps = float(np.finfo(np.float32).eps)
    norms = np.array([1.0, 0.05, 1e-3, 0.5 * eps * 50.0, 2.0 * eps * 50.0])
    np.testing.assert_array_equal(above_norm_floor(norms, 50.0),
                                  [True, True, True, False, True])
    # the explicit mean overrides the mean of the rows passed
    np.testing.assert_array_equal(
        above_norm_floor(norms, 50.0, mean_norm=1e-3),
        norms > np.sqrt(eps) * 1e-3)


def test_streamed_sharded_probe_skips_masked_rows(cpu_devices):
    """A shard whose first row is below the norm floor: that row's stored
    norm is 1 (masked rows carry no norm), so comparing it against its
    re-projection would report a mismatch that is not one.  The
    constructor probes each shard's first selectable row and stays SPMD."""
    from bayesian_coresets_tpu.coresets import (FamilyProjector,
                                                identity_tangent_family)
    from bayesian_coresets_tpu.parallel import make_mesh
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1024, 16)).astype(np.float32)
    for r in (0, 384):                     # first rows of shards 0 and 3
        x[r] = 1e-9 * x.sum(axis=0)
    prj = FamilyProjector(identity_tangent_family())
    c = bct.HilbertCoreset(x, prj, stream_chunk_size=64,
                           mesh=make_mesh({"data": 8}))
    assert c.streamed_sharded_mode == "spmd"
    consts = c.snnls.consts
    probe = c.spmd_probe(x, prj, consts)
    assert [p["row"] for p in probe] == [1, 128, 256, 385, 512, 640, 768, 896]
    assert all(p["ok"] for p in probe)
    first = {p["row"]: p for p in c.spmd_probe(x, prj, consts,
                                                rows=range(0, 1024, 128))}
    for r in (0, 384):
        assert first[r]["norm_spmd"] == 1.0 and not first[r]["ok"]
        assert first[r]["int8_max_diff"] <= 1  # the int8 row itself agrees
    assert all(first[r]["ok"] for r in first if r not in (0, 384))
