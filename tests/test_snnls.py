"""Solver-layer tests: convergence, invariants, parity with scipy NNLS.

Modeled on the reference's implicit invariants (error monotonicity with
rollback, snnls/snnls.py:40-74; nonnegativity) plus closed-form optima on
axis-aligned data (the synthetic_vectors experiment's known-exact case,
reference examples/synthetic_vectors/main.py:65).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import nnls as scipy_nnls

from bayesian_coresets_tpu.ops import (
    GIGA,
    FrankWolfe,
    ImportanceSampling,
    OrthoPursuit,
    UniformSampling,
    nnls_active_set,
    nnls_gram,
)

GREEDY = [GIGA, FrankWolfe, OrthoPursuit]
ALL = GREEDY + [ImportanceSampling, UniformSampling]


def _problem(rng, S=40, n=200, dtype=np.float32):
    A = rng.normal(size=(S, n)).astype(dtype)
    b = A.sum(axis=1)
    return A, b


@pytest.mark.parametrize("cls", ALL)
def test_nonnegative_weights(cls, rng):
    A, b = _problem(rng)
    alg = cls(A, b, max_active=256)
    alg.build(50)
    assert (alg.weights() >= 0).all()


@pytest.mark.parametrize("cls", GREEDY)
def test_error_decreases(cls, rng):
    A, b = _problem(rng)
    alg = cls(A, b, max_active=256)
    e0 = alg.error()
    alg.build(20)
    e20 = alg.error()
    alg.build(60)
    e80 = alg.error()
    assert e20 < e0
    assert e80 <= e20 * (1 + 1e-5)


@pytest.mark.parametrize("cls", GREEDY)
def test_error_monotone_per_iteration(cls, rng):
    A, b = _problem(rng, S=20, n=100)
    alg = cls(A, b, max_active=128)
    errs = []
    for _ in range(40):
        alg.build(1)
        errs.append(alg.error())
    errs = np.array(errs)
    # after the first setup iteration, error never increases materially
    assert (np.diff(errs[1:]) <= errs[1:-1] * 1e-4 + 1e-5).all()


def test_axis_aligned_exact(rng):
    # A's columns = scaled standard basis vectors: GIGA/FW/OMP can represent
    # b exactly once every axis is selected.
    S = 16
    scales = rng.uniform(0.5, 2.0, size=S).astype(np.float32)
    A = np.diag(scales)
    b = A.sum(axis=1)
    for cls in GREEDY:
        alg = cls(A, b, max_active=64)
        alg.build(200)
        alg.optimize()
        assert alg.error() < 1e-3 * np.linalg.norm(b), cls.__name__


def test_sampling_solvers_converge_statistically(rng):
    A, b = _problem(rng, S=10, n=50)
    alg = ImportanceSampling(A, b)
    alg.build(5)
    e5 = alg.error()
    alg.build(2000)
    assert alg.error() < e5


def test_optimize_matches_scipy_on_active_set(rng):
    A, b = _problem(rng, S=30, n=150)
    alg = GIGA(A, b, max_active=256)
    alg.build(40)
    w = alg.weights()
    act = np.flatnonzero(w > 0)
    alg.optimize()
    w_opt, err_scipy = scipy_nnls(np.asarray(A, np.float64)[:, act], np.asarray(b, np.float64))
    # our FISTA solution should reach scipy's optimal residual closely
    assert alg.error() <= err_scipy * (1 + 1e-2) + 1e-4


def test_valid_mask_excludes_columns(rng):
    A, b = _problem(rng, S=20, n=60)
    valid = np.ones(60, bool)
    valid[30:] = False
    alg = GIGA(A, b, valid=jnp.asarray(valid), max_active=64)
    alg.build(100)
    assert (alg.weights()[30:] == 0).all()


def test_zero_column_rejected(rng):
    A, b = _problem(rng, S=10, n=20)
    A[:, 3] = 0.0
    for cls in GREEDY:
        with pytest.raises(ValueError):
            cls(A, b)


def test_determinism(rng):
    A, b = _problem(rng)
    a1 = GIGA(A, b)
    a2 = GIGA(A, b)
    a1.build(30)
    a2.build(30)
    np.testing.assert_array_equal(a1.weights(), a2.weights())


def test_reset(rng):
    A, b = _problem(rng)
    alg = GIGA(A, b)
    alg.build(10)
    alg.reset()
    assert alg.size() == 0
    assert not alg.reached_numeric_limit


def test_incremental_matches_oneshot(rng):
    A, b = _problem(rng)
    a1 = GIGA(A, b)
    a1.build(30)
    a2 = GIGA(A, b)
    for _ in range(6):
        a2.build(5)
    np.testing.assert_allclose(a1.weights(), a2.weights(), rtol=1e-5, atol=1e-6)


class TestNNLSKernels:
    def test_nnls_gram_matches_scipy(self, rng):
        S, k = 30, 12
        A = rng.normal(size=(S, k))
        b = rng.normal(size=S)
        G = (A.T @ A).astype(np.float32)
        c = (A.T @ b).astype(np.float32)
        x = np.asarray(nnls_gram(jnp.asarray(G), jnp.asarray(c), num_iters=2000))
        x_ref, _ = scipy_nnls(A, b)
        np.testing.assert_allclose(x, x_ref, rtol=5e-3, atol=5e-3)

    def test_active_set_padding(self, rng):
        S, n = 20, 40
        V = jnp.asarray(rng.normal(size=(n, S)), jnp.float32)
        b = jnp.asarray(rng.normal(size=S), jnp.float32)
        idcs = jnp.asarray([3, 7, 11, 0, 0, 0], jnp.int32)
        x = np.asarray(nnls_active_set(V, b, idcs, 3, num_iters=1000))
        assert (x[3:] == 0).all()
        x_ref, _ = scipy_nnls(np.asarray(V).T[:, [3, 7, 11]].astype(np.float64),
                              np.asarray(b, np.float64))
        np.testing.assert_allclose(x[:3], x_ref, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("sd", ["bfloat16", "int8"])
def test_reduced_precision_select(sd, rng):
    # reduced-precision selection copies must not degrade quality materially
    import jax.numpy as jnp
    sd = getattr(jnp, sd)
    A, b = _problem(rng, S=50, n=400)
    a32 = GIGA(A, b)
    alo = GIGA(A, b, select_dtype=sd)
    a32.build(100)
    alo.build(100)
    assert alo.error() <= a32.error() * 1.5 + 1e-3


@pytest.mark.parametrize("n", [1, 7, 129, 1025])
@pytest.mark.parametrize("sd", [None, "int8"])
def test_shape_fuzz(n, sd, rng):
    # odd problem sizes exercise the padded selection-copy path end to end
    sd = getattr(jnp, sd) if sd else None
    S = 9
    A = rng.normal(size=(S, n)).astype(np.float32)
    w_true = rng.uniform(0, 2, size=n).astype(np.float32)
    b = A @ w_true
    for cls in (GIGA, FrankWolfe):
        alg = cls(A, b, select_dtype=sd, max_active=64)
        alg.build(min(3 * n, 60))
        w = alg.weights()
        assert w.shape == (n,)
        assert (w >= 0).all()
        assert np.isfinite(alg.error())
        if n == 1:
            # single column: GIGA's built-in optimal scaling is exact at once;
            # FW's vertex init lands at w=1 and (as in the reference) its
            # line search degenerates, but optimize() recovers exactness
            if cls is not GIGA:
                alg.optimize()
            assert alg.error() < 1e-3 * np.linalg.norm(b) + 1e-5


def test_int8_with_valid_mask(rng):
    A, b = _problem(rng, S=20, n=100)
    valid = np.ones(100, bool)
    valid[50:] = False
    alg = GIGA(A, b, valid=jnp.asarray(valid), select_dtype=jnp.int8)
    alg.build(80)
    assert (alg.weights()[50:] == 0).all()


def test_optimize_exact_native(rng):
    from bayesian_coresets_tpu import native
    if not native.available():
        pytest.skip("no C++ toolchain")
    A, b = _problem(rng, S=30, n=150)
    alg = GIGA(A, b)
    alg.build(40)
    e0 = alg.error()
    alg.optimize(solver="exact")
    assert alg.error() <= e0 * (1 + 1e-4)
    # exact solve should match/beat the on-chip FISTA result
    alg2 = GIGA(A, b)
    alg2.build(40)
    alg2.optimize()
    assert alg.error() <= alg2.error() * (1 + 1e-3)


def test_sampling_solver_with_valid_mask(rng):
    A, b = _problem(rng, S=15, n=80)
    valid = np.ones(80, bool)
    valid[40:] = False
    for cls in (ImportanceSampling, UniformSampling):
        alg = cls(A, b, valid=jnp.asarray(valid))
        alg.build(300)
        assert (alg.weights()[40:] == 0).all()
        assert alg.size() > 0


# ---------------------------------------------------------------------------
# int8-resident (beyond-HBM) mode: make_consts_quantized / from_consts
# ---------------------------------------------------------------------------

def _quantize_rows(A):
    """Host-side reference quantization: V rows normalized, scaled to +-127."""
    V = A.T
    norms = np.sqrt((V**2).sum(axis=1))
    safe = np.where(norms > 0, norms, 1.0)
    Vq = np.clip(np.round(V / safe[:, None] * 127.0), -127, 127).astype(np.int8)
    return Vq, norms.astype(np.float32)


@pytest.mark.parametrize("cls", ALL)
def test_quantized_mode_converges(cls, rng):
    from bayesian_coresets_tpu.ops import make_consts_quantized
    A, b = _problem(rng, S=40, n=300)
    Vq, norms = _quantize_rows(A)
    consts = make_consts_quantized(
        jnp.asarray(Vq), jnp.asarray(norms), jnp.asarray(b),
        sampling=cls.method if cls.method in ("importance", "uniform") else None)
    alg = cls.from_consts(consts, max_active=512)
    e0 = alg.error()
    alg.build(80)
    w = alg.weights()
    assert (w >= 0).all()
    assert w[300:].sum() == 0.0            # padded rows never selected
    if cls.method in ("giga", "frankwolfe", "orthopursuit"):
        assert alg.error() < e0
        # greedy solvers should roughly match their f32 counterparts
        ref = cls(A, b, max_active=512)
        ref.build(80)
        assert alg.error() < max(2.0 * ref.error(), 0.05 * e0)
    else:
        # sampling solvers converge statistically (high variance early)
        alg.build(2000)
        assert alg.error() < e0


def test_quantized_matvec_and_error_exact_on_support(rng):
    """error(support=k) must equal the dense dequantized matvec when
    nnz(w) <= k."""
    from bayesian_coresets_tpu.ops import make_consts_quantized
    from bayesian_coresets_tpu.ops.snnls import error as snnls_error
    A, b = _problem(rng, S=16, n=100)
    Vq, norms = _quantize_rows(A)
    consts = make_consts_quantized(jnp.asarray(Vq), jnp.asarray(norms), jnp.asarray(b))
    w = np.zeros(consts.V.shape[0], np.float32)
    idx = rng.choice(100, size=7, replace=False)
    w[idx] = rng.uniform(0.5, 2.0, size=7).astype(np.float32)
    Vdeq = Vq.astype(np.float64) * (norms[:, None] / 127.0)
    want = np.linalg.norm(Vdeq.T @ w[:100] - np.asarray(b, np.float64))
    got = float(snnls_error(consts, jnp.asarray(w), support=16))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_quantized_optimize_paths(rng):
    from bayesian_coresets_tpu.ops import GIGA, make_consts_quantized
    A, b = _problem(rng, S=30, n=150)
    Vq, norms = _quantize_rows(A)
    consts = make_consts_quantized(jnp.asarray(Vq), jnp.asarray(norms), jnp.asarray(b))
    alg = GIGA.from_consts(consts, max_active=256)
    alg.build(40)
    e_before = alg.error()
    alg.optimize()                      # on-chip FISTA on gathered rows
    assert alg.error() <= e_before * (1.0 + 1e-5)
    alg2 = GIGA.from_consts(consts, max_active=256)
    alg2.build(40)
    alg2.optimize(solver="exact")       # native LH on dequantized gather
    assert alg2.error() <= e_before * (1.0 + 1e-5)


# ---------------------------------------------------------------------------
# max_active support-capacity invariant: overflow must latch, never corrupt
# ---------------------------------------------------------------------------

def _axis_problem(S=16):
    # identity columns: every greedy iteration must select a NEW atom
    A = np.eye(S, dtype=np.float32)
    b = A.sum(axis=1)
    return A, b


def test_support_overflow_latches_f32():
    A, b = _axis_problem(S=16)
    alg = GIGA(A, b, max_active=4)
    alg.build(16)
    # exactly max_active distinct atoms committed, then the latch fires
    assert alg.reached_numeric_limit
    w = alg.weights()
    assert (w > 0).sum() <= 4
    # error() reflects the committed weights exactly (nothing silently dropped)
    want = np.linalg.norm(A @ w - b)
    np.testing.assert_allclose(alg.error(), want, rtol=1e-5, atol=1e-6)
    # further builds are no-ops once latched (reference snnls.py:33-35)
    alg.build(10)
    np.testing.assert_array_equal(alg.weights(), w)


def test_support_overflow_latches_int8_resident(rng):
    from bayesian_coresets_tpu.ops import make_consts_quantized
    A, b = _axis_problem(S=16)
    Vq, norms = _quantize_rows(A)
    consts = make_consts_quantized(jnp.asarray(Vq), jnp.asarray(norms), jnp.asarray(b))
    alg = GIGA.from_consts(consts, max_active=4)
    alg.build(16)
    assert alg.reached_numeric_limit
    w = alg.weights()
    assert (w > 0).sum() <= 4
    # error(support=max_active) must match the dense dequantized residual:
    # the tracked support covers every live atom, or the latch fired first
    Vdeq = Vq.astype(np.float64) * (norms[:, None] / 127.0)
    want = np.linalg.norm(Vdeq.T @ w[:16] - np.asarray(b, np.float64))
    np.testing.assert_allclose(alg.error(), want, rtol=1e-4, atol=1e-4)


def test_support_overflow_latches_sampling(rng):
    # uniform draws keep hitting new atoms; the 9th distinct atom must latch
    A, b = _problem(rng, S=12, n=64)
    alg = UniformSampling(A, b, max_active=8)
    alg.build(2000)
    assert alg.reached_numeric_limit
    w = alg.weights()
    assert 0 < (w > 0).sum() <= 8
    want = np.linalg.norm(np.asarray(A, np.float64) @ w - np.asarray(b, np.float64))
    np.testing.assert_allclose(alg.error(), want, rtol=1e-3, atol=1e-4)


def test_no_overflow_below_capacity():
    # same axis problem with enough slots: all 16 atoms commit with no
    # overflow latch (building further would hit the ORDINARY numeric-limit
    # latch once b is exactly represented, which is correct and separate)
    A, b = _axis_problem(S=16)
    alg = GIGA(A, b, max_active=16)
    alg.build(16)
    assert not alg.reached_numeric_limit
    assert (alg.weights() > 0).sum() == 16
    assert alg.error() < 1e-3 * np.linalg.norm(b)


def test_sampling_rank1_cache_matches_exact_matvec(rng):
    # the O(S) incremental xw update must track the exact V^T w image
    from bayesian_coresets_tpu.ops.snnls import error as snnls_error
    A, b = _problem(rng, S=20, n=100)
    alg = ImportanceSampling(A, b, max_active=100)
    alg.build(777)   # not a multiple of the refresh cadence
    w = alg.weights()
    want = np.linalg.norm(np.asarray(A, np.float64) @ w - np.asarray(b, np.float64))
    np.testing.assert_allclose(alg.error(), want, rtol=1e-4, atol=1e-4)


def test_giga_wscale_underflow_fold(rng):
    """The scale-carried GIGA commit must fold the carried scalar back into
    the raw weights before it underflows (_WSCALE_FLOOR): drive one step
    directly with a near-floor aux.wscale and check the returned state
    still encodes the TRUE weights exactly (w_out * wscale_out)."""
    from bayesian_coresets_tpu.ops import snnls as S

    A, b = _problem(rng, S=16, n=48)
    consts = S.make_consts(jnp.asarray(A), jnp.asarray(b))
    state = S.init_state(consts, max_active=16)
    # establish a committed nonzero state first (true scale 1.0)
    state = S.build(consts, state, 3, 1e-6, method="giga")
    w_true = np.asarray(state.w)

    # re-enter one raw step with a carried scale BELOW the fold floor:
    # raw weights = true / ws  (what the loop would be carrying)
    ws = S._WSCALE_FLOOR / 4.0
    raw = state._replace(w=state.w / ws,
                         xw=jnp.asarray(np.asarray(A, np.float64) @ w_true,
                                        jnp.float32))
    aux = S._aux_from_xw(consts, raw.xw, wscale=ws)
    out = S._giga_step(consts, raw, aux, 1e-6)
    w2, xw2, aux2 = out[0], out[1], out[8]
    assert float(aux2.wscale) == 1.0, "fold must reset the carried scale"
    # folded raw weights ARE the true weights now; the step committed one
    # more atom on top of the round-3 state
    w_folded = np.asarray(w2)
    assert np.all(np.isfinite(w_folded))
    err_new = float(aux2.err)
    err_old = float(aux.err)
    assert err_new <= err_old * (1.0 + 1e-5), "committed step must not regress"
    # cached image matches the folded weights exactly on the support
    np.testing.assert_allclose(
        np.asarray(xw2), np.asarray(A, np.float64) @ w_folded,
        rtol=2e-4, atol=2e-4)


def test_bpsvi_uniform_init_idcs():
    """Host-side init draw: deterministic in the key, without replacement,
    in range."""
    import jax as _jax
    from bayesian_coresets_tpu.coresets.bpsvi import uniform_init_idcs

    k = _jax.random.key(42)
    a = np.asarray(uniform_init_idcs(1000, 64, k))
    b2 = np.asarray(uniform_init_idcs(1000, 64, k))
    np.testing.assert_array_equal(a, b2)
    assert len(set(a.tolist())) == 64
    assert a.min() >= 0 and a.max() < 1000
    c = np.asarray(uniform_init_idcs(1000, 64, _jax.random.key(43)))
    assert not np.array_equal(a, c)


def test_giga_long_build_refresh_exactness(rng):
    """A 200-iteration GIGA build crosses the REFRESH_EVERY cadence three
    times: the support-gather refresh and the scale-carry fold must keep
    the cached state consistent — the final error() must match a dense
    f64 recomputation from the returned (true-scale) weights."""
    A, b = _problem(rng, S=30, n=400)
    alg = GIGA(A, b, max_active=256)
    alg.build(200)
    w = alg.weights()
    assert (w >= 0).all()
    want = np.linalg.norm(np.asarray(A, np.float64) @ w - np.asarray(b, np.float64))
    np.testing.assert_allclose(alg.error(), want, rtol=1e-4, atol=1e-5)


def test_fw_long_build_refresh_exactness(rng):
    """Same refresh/scale-carry consistency check for Frank-Wolfe."""
    from bayesian_coresets_tpu.ops import snnls as S

    A, b = _problem(rng, S=30, n=400)
    alg = FrankWolfe(A, b, max_active=256)
    alg.build(200)
    w = alg.weights()
    assert (w >= 0).all()
    want = np.linalg.norm(np.asarray(A, np.float64) @ w - np.asarray(b, np.float64))
    np.testing.assert_allclose(alg.error(), want, rtol=1e-4, atol=1e-5)


def _int8_select_case(rows, S, Sp, k, seed=0):
    from bayesian_coresets_tpu.ops import make_consts
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(rows, S)).astype(np.float32)
    consts = make_consts(jnp.asarray(V.T), jnp.asarray(V.sum(0)),
                         select_dtype=jnp.int8)
    dirs = rng.normal(size=(S, k)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=0)
    q = np.clip(np.round(np.pad(dirs, ((0, Sp - S), (0, 0))) * 127), -127, 127)
    ref = np.asarray(consts.Vsel, np.float64) @ q / 127.0 ** 2
    return consts, jnp.asarray(dirs), ref[:rows]


def test_int8_select_scale_stays_out_of_the_gemm():
    """The int8 score dot is fenced before its 1/127^2 scale: XLA:GPU's
    split-K rewrite otherwise moves the scale into int32 and zeroes it."""
    from bayesian_coresets_tpu.ops.snnls import _select_dots
    consts, dirs, ref = _int8_select_case(1000, 100, 128, 2)
    fn = jax.jit(_select_dots)
    assert "optimization_barrier" in fn.lower(consts, dirs).as_text()
    np.testing.assert_allclose(np.asarray(fn(consts, dirs)), ref, atol=1e-6)


@pytest.mark.chip
def test_int8_select_dots_exact_on_gpu(gpu):
    """At 100352 x 512 XLA splits K for the int8 select; the scores must
    still equal the integer products."""
    from bayesian_coresets_tpu.ops.snnls import _select_dots
    consts, dirs, ref = _int8_select_case(100_000, 500, 512, 2)
    got = np.asarray(jax.jit(_select_dots)(consts, dirs))
    np.testing.assert_allclose(got, ref, atol=1e-6)
