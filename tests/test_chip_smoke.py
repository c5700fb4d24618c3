"""chip_smoke.py off the card: it refuses to run without a GPU, its
comparisons reject what they must, and every phase passes against its
reference at a tiny size on the CPU.  Tests marked ``chip`` run the phases
against the CPU reference on a real GPU and skip elsewhere.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from bayesian_coresets_tpu.utils import cache  # noqa: E402


def _run_script(script: Path, cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_refuses_without_gpu():
    _assert_refused(_run_script(ROOT / "chip_smoke.py", ROOT))


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run_script(tmp_path / "chip_smoke.py", tmp_path))


def _round_mantissa(x, bits):
    """Round float32 values to ``bits`` explicit mantissa bits."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.round(m * 2.0 ** (bits + 1)) / 2.0 ** (bits + 1), e)


def test_projection_check_rejects_tf32_accepts_highest():
    Z = cs.logistic_data(2000, 10, 0)
    ths = cs.reference_samples(Z, 64, 1)
    with cs.reference():
        ref = np.asarray(cs._project(Z, ths))
    with jax.default_matmul_precision("highest"):
        again = np.asarray(cs._project(Z, ths))
    assert cs.check_projection(again, ref)["ok"]
    assert not cs.check_projection(_round_mantissa(ref, 10), ref)["ok"]


@pytest.mark.parametrize("order, resid, ok", [
    (list(range(16)), 1.01, True),
    (list(range(15)) + [99], 1.0, False),    # diverged inside the prefix
    (list(range(16)), 1.03, False),          # residual off by 3 %
    (list(range(10)), 1.0, False),           # stopped before 16 picks
])
def test_giga_check(order, resid, ok):
    checks = cs.check_giga(order, resid, np.ones(3), list(range(20)), 1.0)
    assert all(c["ok"] for c in checks) == ok


def test_giga_check_rejects_negative_or_nan_weights():
    for w in (np.array([1.0, -1.0]), np.array([1.0, np.nan])):
        checks = cs.check_giga(range(16), 1.0, w, range(16), 1.0)
        assert not all(c["ok"] for c in checks)


def test_nuts_check_rejects_shifted_mean():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((8, 400, 2)).astype(np.float32)
    summ = cs.nuts_summary(s)
    assert all(c["ok"] for c in cs.check_nuts(summ, summ))
    shifted = cs.nuts_summary(s + 0.5)
    assert not all(c["ok"] for c in cs.check_nuts(shifted, summ))


def test_kl_check():
    assert cs.check_kl(0.10, 0.08, "kl")["ok"]
    assert not cs.check_kl(0.20, 0.08, "kl")["ok"]
    assert not cs.check_kl(float("nan"), 0.08, "kl")["ok"]


def test_classify_select_dot():
    hlo = ("%x = s8[1024,128]{1,0} parameter(0)\n"
           "%dot.1 = s32[1024,2]{1,0} dot(%x, %q), lhs_contracting_dims={1}\n")
    assert cs.classify_select_dot(hlo, 1024)[0] == "XLA dot"
    hlo = ('%cc = (s32[1024,2]{1,0}, s8[0]{0}) custom-call(%x, %q), '
           'custom_call_target="__cublas$gemm"\n')
    assert cs.classify_select_dot(hlo, 1024)[0] == "cuBLAS custom call"
    hlo = ("%gemm_fusion_dot.3_computation (p0: s8[1024,128]) -> f32[1024,2] {\n"
           "  %dot.3 = s32[1024,2]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}\n"
           "}\n"
           "%body (c: s8[1024,128]) -> f32[1024,2] {\n"
           '  %gemm_fusion_dot.3 = f32[1024,2]{1,0} fusion(%c, %q), kind=kCustom, '
           'calls=%gemm_fusion_dot.3_computation, '
           'backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}\n'
           "}\n")
    kind, lines = cs.classify_select_dot(hlo, 1024)
    assert kind == "Triton fusion" and len(lines) == 2
    assert cs.classify_select_dot("", 1024)[0] == "not found"


def test_compilation_cache_honours_env(monkeypatch):
    calls = []
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(cache.CACHE_ENV, "/some/where")
    assert cache.enable_compilation_cache() == "/some/where"
    assert calls == []


def test_compilation_cache_fixed_path_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    first = cache.enable_compilation_cache()
    second = cache.enable_compilation_cache()
    assert first == second == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def _all_ok(result):
    bad = [c for c in result["checks"] if not c["ok"]]
    assert not bad, bad


def test_phase_precision_tiny():
    r = cs.phase_precision(256, 64, 32)
    assert r["metrics"]["tf32_at_default"] is False     # float32 on the CPU


def test_phase_model_projections_tiny():
    r = cs.phase_model_projections(n=500, S=32)
    _all_ok(r)
    assert [c["check"].split("_")[0] for c in r["checks"]] == [
        "poisson", "gaussian", "linreg"]


def test_projection_dots_are_pinned_to_highest():
    """Every dot in each model's log-likelihood runs at HIGHEST precision,
    so a GPU cannot take it to TF32 (the CPU computes float32 either way,
    so the jaxpr is where this shows here)."""
    cases = cs._model_projection_cases(300, 16, 0)
    cases.append(("logistic", np.ones((4, 10), np.float32),
                  np.ones((16, 10), np.float32), cs.logistic.log_likelihood))
    for name, z, th, ll in cases:
        eqns = [e for e in jax.make_jaxpr(ll)(z, th).jaxpr.eqns
                if e.primitive.name == "dot_general"]
        assert eqns, name
        for e in eqns:
            assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2, name


def test_require_gpu_refuses_the_cpu():
    from bayesian_coresets_tpu.utils import require_gpu
    with pytest.raises(SystemExit) as e:
        require_gpu()
    assert e.value.code != 0


@pytest.mark.parametrize("stream", [False, True])
def test_phase_giga_tiny(stream):
    kw = dict(stream_chunk_size=1500, ref_chunk_size=700) if stream else {}
    r = cs.phase_giga(3000, 2000, S=48, M=30, **kw)
    _all_ok(r)
    m = r["metrics"]
    assert m["iterations"] > 0 and m["select_dot"] == "XLA dot"
    pts, wts = r["coreset"]
    assert pts.shape == (wts.size, 10) and np.all(wts > 0)


def test_phase_nuts_tiny():
    r = cs.phase_giga(3000, 2000, S=48, M=30)
    _all_ok(cs.phase_nuts(*r["coreset"], n_samples=300, chains=16,
                          ref_chains=16))


def test_phase_sparsevi_tiny():
    _all_ok(cs.phase_sparsevi(N=200, d=10, S=30, M=8, opt_itrs=10))


def test_phase_bpsvi_tiny():
    _all_ok(cs.phase_bpsvi(N=2000, N_ref=1000, d=5, S=30, sz=10, opt_itrs=50))


def test_four_card_phases_tiny(cpu_devices):
    r = cs.phase_sharded_build(1 << 14, S=64, M=40)
    _all_ok(r)
    _all_ok(cs.phase_streamed_sharded(1 << 14, S=64, M=40, chunk=3000))
    _all_ok(cs.phase_sharded_nuts(*r["coreset"], n_samples=300, chains=32))


@pytest.mark.chip
def test_giga_matches_cpu_reference_on_gpu(gpu):
    _all_ok(cs.phase_giga(200_000, 20_000))


@pytest.mark.chip
def test_sparsevi_matches_cpu_reference_on_gpu(gpu):
    _all_ok(cs.phase_sparsevi())
