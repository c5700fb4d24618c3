"""Model-layer golden tests: closed forms vs autodiff and NumPy re-derivations.

The reference ships no tests (SURVEY.md §4); these validate our stable
closed-form gradients/Hessians against jax autodiff and the conjugate
posteriors against direct NumPy solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_coresets_tpu.models import gaussian, linreg, logistic, poisson
from bayesian_coresets_tpu.models.laplace import laplace_approx, sample_laplace


def _as_np(x):
    return np.asarray(x, dtype=np.float64)


class TestGaussian:
    def test_log_likelihood_matches_direct(self, rng):
        d, n, S = 4, 7, 5
        x = rng.normal(size=(n, d)).astype(np.float32)
        th = rng.normal(size=(S, d)).astype(np.float32)
        A = rng.normal(size=(d, d))
        Sig = (A @ A.T + d * np.eye(d)).astype(np.float32)
        Siginv = np.linalg.inv(Sig).astype(np.float32)
        logdet = np.linalg.slogdet(Sig)[1]
        got = np.asarray(gaussian.log_likelihood(x, th, Siginv, logdet))
        # direct multivariate normal log-pdf
        from scipy.stats import multivariate_normal
        want = np.stack([multivariate_normal.logpdf(x, mean=t, cov=Sig) for t in th], axis=1)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def test_grad_x_matches_autodiff(self, rng):
        d, n, S = 3, 4, 2
        x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
        th = jnp.asarray(rng.normal(size=(S, d)), jnp.float32)
        Siginv = jnp.eye(d) * 2.0
        got = gaussian.grad_x_log_likelihood(x, th, Siginv)
        f = lambda xi, ti: gaussian.log_likelihood(xi[None], ti[None], Siginv, 0.0)[0, 0]
        want = jax.vmap(lambda xi: jax.vmap(lambda ti: jax.grad(f)(xi, ti))(th))(x)
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=1e-4, atol=1e-4)

    def test_weighted_post_solves_normal_equations(self, rng):
        d, n = 5, 20
        x = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.uniform(0, 2, size=n).astype(np.float32)
        th0 = rng.normal(size=d).astype(np.float32)
        Sig0inv = np.eye(d, dtype=np.float32) * 0.5
        Siginv = np.eye(d, dtype=np.float32) * 1.5
        post = gaussian.weighted_post(th0, Sig0inv, Siginv, x, w)
        prec = Sig0inv + w.sum() * Siginv
        mu_want = np.linalg.solve(prec, Sig0inv @ th0 + Siginv @ (w[:, None] * x).sum(0))
        np.testing.assert_allclose(_as_np(post.mu), mu_want, rtol=1e-4, atol=1e-4)
        Sig = _as_np(post.USig) @ _as_np(post.USig).T
        np.testing.assert_allclose(Sig, np.linalg.inv(prec), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_as_np(post.LSigInv) @ _as_np(post.LSigInv).T, prec,
                                   rtol=1e-3, atol=1e-3)

    def test_kl_properties(self, rng):
        d = 4
        mu = rng.normal(size=d).astype(np.float32)
        Sig = np.eye(d, dtype=np.float32)
        assert abs(float(gaussian.kl_divergence(mu, Sig, mu, Sig))) < 1e-4
        mu2 = mu + 1.0
        assert float(gaussian.kl_divergence(mu, Sig, mu2, Sig)) > 0.1

    def test_posterior_basis_matches_weighted_post(self, rng):
        # non-diagonal, non-commuting prior/likelihood precisions
        d, n = 6, 15
        A0 = rng.normal(size=(d, d))
        Sig0inv = (A0 @ A0.T / d + np.eye(d)).astype(np.float32)
        A1 = rng.normal(size=(d, d))
        Siginv = (A1 @ A1.T / d + 0.5 * np.eye(d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.uniform(0, 2, size=n).astype(np.float32)
        th0 = rng.normal(size=d).astype(np.float32)

        basis = gaussian.posterior_basis(th0, Sig0inv, Siginv)
        mu_fast, F = gaussian.weighted_post_basis(basis, x, w)
        post = gaussian.weighted_post(th0, Sig0inv, Siginv, x, w)
        np.testing.assert_allclose(_as_np(mu_fast), _as_np(post.mu),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_as_np(F) @ _as_np(F).T,
                                   _as_np(post.USig) @ _as_np(post.USig).T,
                                   rtol=1e-3, atol=1e-4)
        # zero-weight (empty coreset) case falls back to the prior posterior
        mu0_fast, F0 = gaussian.weighted_post_basis(
            basis, np.zeros((0, d), np.float32), np.zeros((0,), np.float32))
        post0 = gaussian.weighted_post(th0, Sig0inv, Siginv,
                                       np.zeros((0, d), np.float32),
                                       np.zeros((0,), np.float32))
        np.testing.assert_allclose(_as_np(mu0_fast), _as_np(post0.mu),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_as_np(F0) @ _as_np(F0).T,
                                   _as_np(post0.USig) @ _as_np(post0.USig).T,
                                   rtol=1e-3, atol=1e-4)

    def test_sample_weighted_post_basis_moments(self, rng):
        d, n, S = 3, 10, 200_000
        Sig0inv = np.eye(d, dtype=np.float32) * 0.7
        Siginv = np.eye(d, dtype=np.float32) * 1.3
        x = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.uniform(0, 2, size=n).astype(np.float32)
        th0 = rng.normal(size=d).astype(np.float32)
        basis = gaussian.posterior_basis(th0, Sig0inv, Siginv)
        ths = np.asarray(gaussian.sample_weighted_post_basis(
            jax.random.key(3), basis, x, w, S))
        post = gaussian.weighted_post(th0, Sig0inv, Siginv, x, w)
        Sig = _as_np(post.USig) @ _as_np(post.USig).T
        np.testing.assert_allclose(ths.mean(0), _as_np(post.mu), atol=3e-2)
        np.testing.assert_allclose(np.cov(ths.T), Sig, atol=3e-2)


class TestLogistic:
    def test_grads_match_autodiff(self, rng):
        d, n, S = 3, 5, 4
        z = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
        th = jnp.asarray(rng.normal(size=(S, d)), jnp.float32)
        f = lambda zi, ti: logistic.log_likelihood(zi[None], ti[None])[0, 0]
        want_th = jax.vmap(lambda zi: jax.vmap(lambda ti: jax.grad(f, 1)(zi, ti))(th))(z)
        np.testing.assert_allclose(_as_np(logistic.grad_th_log_likelihood(z, th)),
                                   _as_np(want_th), rtol=1e-4, atol=1e-5)
        want_z = jax.vmap(lambda zi: jax.vmap(lambda ti: jax.grad(f, 0)(zi, ti))(th))(z)
        np.testing.assert_allclose(_as_np(logistic.grad_z_log_likelihood(z, th)),
                                   _as_np(want_z), rtol=1e-4, atol=1e-5)

    def test_hessian_matches_autodiff(self, rng):
        d, n = 3, 6
        z = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
        th = jnp.asarray(rng.normal(size=(1, d)), jnp.float32)
        w = jnp.asarray(rng.uniform(0.5, 1.5, size=n), jnp.float32)
        got = logistic.hess_th_log_joint(z, th, w)[0]
        f = lambda t: logistic.log_joint(z, t[None], w)[0]
        want = jax.hessian(f)(th[0])
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=1e-3, atol=1e-4)
        diag = logistic.diag_hess_th_log_joint(z, th, w)[0]
        np.testing.assert_allclose(_as_np(diag), np.diag(_as_np(want)), rtol=1e-3, atol=1e-4)

    def test_stability_extreme_logits(self):
        z = jnp.array([[100.0, 0.0], [-100.0, 0.0]], jnp.float32)
        th = jnp.array([[10.0, 0.0]], jnp.float32)
        ll = logistic.log_likelihood(z, th)
        assert np.isfinite(_as_np(ll)).all()
        g = logistic.grad_th_log_likelihood(z, th)
        assert np.isfinite(_as_np(g)).all()


class TestPoisson:
    def _data(self, rng, n=6, S=3):
        z = np.asarray(poisson.gen_synthetic(jax.random.key(3), n))
        th = rng.normal(size=(S, 2)).astype(np.float32)
        return jnp.asarray(z), jnp.asarray(th)

    def test_loglik_matches_scipy(self, rng):
        z, th = self._data(rng)
        from scipy.stats import poisson as sp_poisson
        x, y = np.asarray(z[:, :-1], np.float64), np.asarray(z[:, -1], np.float64)
        lam = np.log1p(np.exp(x @ np.asarray(th, np.float64).T))
        want = sp_poisson.logpmf(y[:, None], lam)
        got = _as_np(poisson.log_likelihood(z, th))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_grads_match_autodiff(self, rng):
        z, th = self._data(rng)
        f = lambda zi, ti: poisson.log_likelihood(zi[None], ti[None])[0, 0]
        want = jax.vmap(lambda zi: jax.vmap(lambda ti: jax.grad(f, 1)(zi, ti))(th))(z)
        got = poisson.grad_th_log_likelihood(z, th)
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=2e-3, atol=1e-4)

    def test_hess_matches_autodiff(self, rng):
        z, th = self._data(rng, S=1)
        w = jnp.ones(z.shape[0])
        got = poisson.hess_th_log_joint(z, th, w)[0]
        f = lambda t: poisson.log_joint(z, t[None], w)[0]
        want = jax.hessian(f)(th[0])
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=2e-3, atol=1e-3)


class TestLinreg:
    def test_weighted_post_matches_numpy(self, rng):
        d, n = 4, 30
        x = rng.normal(size=(n, d)).astype(np.float32)
        thtrue = rng.normal(size=d)
        y = (x @ thtrue + 0.1 * rng.normal(size=n)).astype(np.float32)
        z = np.hstack([x, y[:, None]])
        w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
        sigsq = 0.5
        th0 = np.zeros(d, np.float32)
        Sig0inv = np.eye(d, dtype=np.float32)
        post = linreg.weighted_post(th0, Sig0inv, sigsq, z, w)
        prec = Sig0inv + (w[:, None] * x).T @ x / sigsq
        mu_want = np.linalg.solve(prec, (w * y) @ x / sigsq)
        np.testing.assert_allclose(_as_np(post.mu), mu_want, rtol=1e-3, atol=1e-3)

    def test_grad_x_matches_autodiff(self, rng):
        d, n, S = 3, 4, 2
        z = jnp.asarray(rng.normal(size=(n, d + 1)), jnp.float32)
        th = jnp.asarray(rng.normal(size=(S, d)), jnp.float32)
        sigsq = 0.7
        f = lambda zi, ti: linreg.log_likelihood(zi[None], ti[None], sigsq)[0, 0]
        want = jax.vmap(lambda zi: jax.vmap(lambda ti: jax.grad(f, 0)(zi, ti))(th))(z)
        got = linreg.grad_x_log_likelihood(z, th, sigsq)
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=1e-4, atol=1e-4)


class TestLaplace:
    def test_matches_scipy_on_logistic(self, rng):
        d, n = 3, 200
        z = np.asarray(logistic.gen_synthetic(jax.random.key(0), n, d, theta_scale=1.0))
        w = np.ones(n, np.float32)
        res = laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.zeros(d),
                             grad_fn=logistic.grad_th_log_joint,
                             hess_fn=logistic.hess_th_log_joint)
        from scipy.optimize import minimize
        zz = z.astype(np.float64)
        f = lambda t: -float(logistic.log_joint(jnp.asarray(zz, jnp.float32),
                                                jnp.asarray(t, jnp.float32)[None], jnp.asarray(w))[0])
        out = minimize(f, np.zeros(d), method="Nelder-Mead", options={"xatol": 1e-8, "fatol": 1e-10})
        np.testing.assert_allclose(_as_np(res.mu), out.x, rtol=2e-3, atol=2e-3)
        # covariance factor reproduces inv(-H)
        H = _as_np(logistic.hess_th_log_joint(jnp.asarray(z), res.mu[None], jnp.asarray(w))[0])
        Sig = _as_np(res.USig) @ _as_np(res.USig).T
        np.testing.assert_allclose(Sig, np.linalg.inv(-H), rtol=1e-3, atol=1e-4)

    def test_sampling_moments(self, rng):
        d, n = 2, 100
        z = logistic.gen_synthetic(jax.random.key(1), n, d, theta_scale=1.0)
        res = laplace_approx(z, jnp.ones(n), jnp.zeros(d),
                             grad_fn=logistic.grad_th_log_joint,
                             hess_fn=logistic.hess_th_log_joint)
        s = np.asarray(sample_laplace(jax.random.key(2), res, 40000))
        np.testing.assert_allclose(s.mean(0), _as_np(res.mu), atol=0.02)
        Sig = _as_np(res.USig) @ _as_np(res.USig).T
        np.testing.assert_allclose(np.cov(s, rowvar=False), Sig, atol=0.02)


class TestLaplaceDiag:
    def test_diag_mode(self, rng):
        d, n = 3, 300
        z = logistic.gen_synthetic(jax.random.key(5), n, d, theta_scale=1.0)
        full = laplace_approx(z, jnp.ones(n), jnp.zeros(d),
                              grad_fn=logistic.grad_th_log_joint,
                              hess_fn=logistic.hess_th_log_joint)
        diag = laplace_approx(z, jnp.ones(n), jnp.zeros(d),
                              grad_fn=logistic.grad_th_log_joint,
                              hess_fn=logistic.diag_hess_th_log_joint, diag=True)
        # same mode; diagonal covariance approximates the diagonal of the full
        np.testing.assert_allclose(_as_np(diag.mu), _as_np(full.mu), atol=1e-3)
        full_var = np.diag(_as_np(full.USig) @ _as_np(full.USig).T)
        diag_var = _as_np(diag.USig) ** 2
        np.testing.assert_allclose(diag_var, full_var, rtol=0.5)
        s = sample_laplace(jax.random.key(0), diag, 20000, diag=True)
        np.testing.assert_allclose(np.asarray(s).mean(0), _as_np(diag.mu), atol=0.02)


def test_kl_divergence_np_f64_robustness(rng):
    # f32 slogdet cancellation must not produce negative KLs; the f64 host
    # metric stays nonnegative on ill-conditioned near-identical Gaussians
    from bayesian_coresets_tpu.models.gaussian import kl_divergence_np
    d = 50
    Q = np.linalg.qr(rng.normal(size=(d, d)))[0]
    evals = np.logspace(-6, 4, d)
    Sig = (Q * evals) @ Q.T
    mu = rng.normal(size=d)
    kl_same = kl_divergence_np(mu, Sig, mu, np.linalg.inv(Sig))
    assert abs(kl_same) < 1e-4
    Sig2 = Sig * 1.01
    assert kl_divergence_np(mu, Sig, mu, np.linalg.inv(Sig2)) >= 0


class TestLinregLowRank:
    def test_matches_qr_posterior(self, rng):
        d, m = 12, 5
        x = rng.normal(size=(m, d)).astype(np.float32)
        y = rng.normal(size=m).astype(np.float32)
        z = np.concatenate([x, y[:, None]], axis=1)
        w = rng.uniform(0, 3, size=m).astype(np.float32)
        th0 = rng.normal(size=d).astype(np.float32)
        A0 = rng.normal(size=(d, d))
        Sig0inv = (A0 @ A0.T / d + np.eye(d)).astype(np.float32)
        sigsq = 0.25

        basis = linreg.lowrank_basis(th0, Sig0inv, sigsq)
        mu_lr, F = linreg.weighted_post_lowrank(basis, z, w)
        post = linreg.weighted_post(th0, Sig0inv, sigsq, z, w)
        np.testing.assert_allclose(_as_np(mu_lr), _as_np(post.mu), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_as_np(F) @ _as_np(F).T,
                                   _as_np(post.USig) @ _as_np(post.USig).T,
                                   rtol=2e-3, atol=2e-3)

    def test_zero_weights_give_prior(self, rng):
        d, m = 6, 4
        z = rng.normal(size=(m, d + 1)).astype(np.float32)
        th0 = rng.normal(size=d).astype(np.float32)
        Sig0inv = np.eye(d, dtype=np.float32) * 2.0
        basis = linreg.lowrank_basis(th0, Sig0inv, 0.5)
        mu_lr, F = linreg.weighted_post_lowrank(basis, z, np.zeros(m, np.float32))
        np.testing.assert_allclose(_as_np(mu_lr), th0, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_as_np(F) @ _as_np(F).T, np.linalg.inv(Sig0inv),
                                   rtol=1e-4, atol=1e-4)


class TestLogLikelihoodDiff:
    """Stable per-datum ll(th) - ll(ref): the mode-relative weighted density
    must stay f32-accurate where naive subtraction cancels (the mechanism
    that left biketrips/airportdelays coreset NUTS unconverged in float32)."""

    def _f64(self, fn, *args):
        with jax.enable_x64():
            return np.asarray(fn(*[jnp.asarray(np.asarray(a), jnp.float64)
                                   for a in args]))

    def test_logistic_matches_f64(self, rng):
        z = jnp.asarray(rng.normal(size=(50, 4)).astype(np.float32) * 5.0)
        ref = jnp.asarray(rng.normal(size=4).astype(np.float32))
        th = ref[None, :] + 0.01 * jnp.asarray(rng.normal(size=(7, 4)).astype(np.float32))
        got = _as_np(logistic.log_likelihood_diff(z, th, ref))
        want = self._f64(lambda zz, tt, rr: logistic.log_likelihood(zz, tt)
                         - logistic.log_likelihood(zz, rr[None, :]),
                         z, th, ref)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    def test_logistic_far_from_ref(self, rng):
        # |logit difference| > 30 exercises the direct-subtraction branch
        z = jnp.asarray(rng.normal(size=(20, 3)).astype(np.float32) * 10.0)
        ref = jnp.zeros(3, jnp.float32)
        th = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32) * 20.0)
        got = _as_np(logistic.log_likelihood_diff(z, th, ref))
        want = self._f64(lambda zz, tt, rr: logistic.log_likelihood(zz, tt)
                         - logistic.log_likelihood(zz, rr[None, :]),
                         z, th, ref)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def _poisson_workload(self, rng, n=200):
        # biketrips-like: large counts, rates matched to them -> |ll| ~ 1e3
        x = np.concatenate([rng.normal(size=(n, 8)), np.ones((n, 1))],
                           axis=1).astype(np.float32)
        th_true = rng.normal(size=9).astype(np.float32)
        lam = np.log1p(np.exp(np.clip(x @ th_true + 6.0, -30, 30)))
        y = rng.poisson(lam).astype(np.float32)
        z = np.concatenate([x, y[:, None]], axis=1).astype(np.float32)
        return jnp.asarray(z), th_true

    def test_poisson_matches_f64(self, rng):
        z, th_true = self._poisson_workload(rng)
        ref = jnp.asarray(th_true).at[-1].add(6.0)
        th = ref[None, :] + 0.005 * jnp.asarray(
            np.random.default_rng(0).normal(size=(7, 9)).astype(np.float32))
        got = _as_np(poisson.log_likelihood_diff(z, th, ref))
        want = self._f64(lambda zz, tt, rr: poisson.log_likelihood(zz, tt)
                         - poisson.log_likelihood(zz, rr[None, :]),
                         z, th, ref)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_poisson_diff_at_guard_boundary(self, rng):
        """Pin the v = -25 softplus-guard boundary (poisson.py fallback
        region): log_likelihood_diff must match the f64 direct difference
        when the logits straddle the guard in every combination (va/vb
        above, below, and AT the floor), including datapoints with y > 0 —
        the docstring's 'no y>0 mass there' claim is about posteriors, not
        about what the function must return when evaluated there."""
        from bayesian_coresets_tpu.models.poisson import _V_FLOOR

        # d=2: [scale, intercept] so each datapoint's logit is exactly
        # intercept + scale*th0; rows place va/vb around the floor
        x = np.array([[1.0, 0.0]] * 6, np.float32)
        y = np.array([0.0, 1.0, 3.0, 0.0, 2.0, 5.0], np.float32)
        z = jnp.asarray(np.concatenate([x, y[:, None]], axis=1))
        f = float(_V_FLOOR)
        # thetas: logits relative to the floor: far below, just below, AT,
        # just above, far above
        ths = jnp.asarray(np.array(
            [[f - 10.0, 0.0], [f - 0.5, 0.0], [f, 0.0],
             [f + 0.5, 0.0], [f + 10.0, 0.0], [0.5, 0.0]], np.float32))
        for ref_v in (f - 5.0, f - 0.25, f, f + 0.25, f + 5.0):
            ref = jnp.asarray(np.array([ref_v, 0.0], np.float32))
            got = _as_np(poisson.log_likelihood_diff(z, ths, ref))
            want = self._f64(lambda zz, tt, rr: poisson.log_likelihood(zz, tt)
                             - poisson.log_likelihood(zz, rr[None, :]),
                             z, ths, ref)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"ref logit {ref_v}")

    def test_poisson_beats_naive_f32(self, rng):
        """The stable form must be orders of magnitude more accurate than
        f32 subtraction on the weighted sum that feeds NUTS energies, at
        the scale where the failure was observed: a ~30-point coreset of
        biketrips_large (counts ~1e3, weights ~N/M ~ 500)."""
        z, th_true = self._poisson_workload(rng, n=32)
        ref = jnp.asarray(th_true).at[-1].add(6.0)
        th = ref[None, :] + 0.003 * jnp.asarray(rng.normal(size=(64, 9)).astype(np.float32))
        w = jnp.asarray(rng.uniform(200.0, 800.0, size=32).astype(np.float32))

        truth = self._f64(lambda zz, tt, rr, ww:
                          ww @ (poisson.log_likelihood(zz, tt)
                                - poisson.log_likelihood(zz, rr[None, :])),
                          z, th, ref, w)
        stable = np.asarray(w @ poisson.log_likelihood_diff(z, th, ref))
        naive = np.asarray(w @ (poisson.log_likelihood(z, th)
                                - poisson.log_likelihood(z, ref[None, :])))
        err_stable = np.abs(stable - truth).max()
        err_naive = np.abs(naive - truth).max()
        # naive error at this scale is a meaningful fraction of a NUTS
        # energy budget; the stable form must stay well under it.  (The
        # measured gap here, ~8-12x, is a LOWER bound: rounding errors of
        # ll(th) and ll(ref) are correlated for the small th-ref offsets
        # this test can afford in f32, and decorrelate over real NUTS
        # trajectories.)
        assert err_stable < 2e-3, err_stable
        assert err_stable * 5 < err_naive, (err_stable, err_naive)

    def test_poisson_grad_finite_and_accurate(self, rng):
        z, th_true = self._poisson_workload(rng)
        ref = jnp.asarray(th_true).at[-1].add(6.0)
        w = jnp.asarray(rng.uniform(10.0, 60.0, size=z.shape[0]).astype(np.float32))
        f = lambda t: w @ poisson.log_likelihood_diff(z, t[None, :], ref)[:, 0]
        g = jax.grad(f)(ref + 0.002)
        assert np.isfinite(_as_np(g)).all()
        # the ll(ref) term is constant in theta, so the f64 truth is just
        # the gradient of the weighted log-likelihood itself
        want = self._f64(
            lambda zz, tt, ww: jax.grad(
                lambda t: ww @ poisson.log_likelihood(zz, t[None, :])[:, 0])(tt),
            z, ref + 0.002, w)
        np.testing.assert_allclose(_as_np(g), want, rtol=1e-3, atol=1e-2)

    def test_softplus_diff_deep_negative_offset(self):
        """d in (-30, -17] with saturated sigmoid(q): f32 expm1(d) rounds to
        exactly -1, so a one-sided log1p(sigmoid(q)*expm1(d)) returns -inf
        (and NaNs the gradient through where).  The sign-symmetric form must
        stay finite and accurate."""
        from bayesian_coresets_tpu.models.logistic import _softplus_diff
        p = jnp.float32(20.0 - 25.0)   # d = -25
        q = jnp.float32(20.0)
        got = float(_softplus_diff(p, q))
        with jax.enable_x64():
            want = float(jax.nn.softplus(jnp.float64(p))
                         - jax.nn.softplus(jnp.float64(q)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        g = jax.grad(lambda a: _softplus_diff(a, q))(p)
        assert np.isfinite(float(g))
