"""scripts/trace_giga.py off the card: its trace summary and its refusal to
run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import trace_giga  # noqa: E402


def _meta(pid, name, tid=None):
    if tid is None:
        return {"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": name}}
    return {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def _kernel(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": dur}


def test_summarize_counts_gpu_streams_only():
    trace = {"traceEvents": [
        _meta(1, "/host:CPU"), _meta(1, "python", tid=5),
        _meta(2, "/device:GPU:0"), _meta(2, "Stream #13(Compute)", tid=13),
        _meta(2, "Stream #14(MemcpyH2D)", tid=14),
        _kernel(1, 5, "host_work", 0.0, 1000.0),
        _kernel(2, 13, "gemm_fusion", 0.0, 30.0),
        _kernel(2, 13, "reduce", 40.0, 10.0),
        _kernel(2, 13, "gemm_fusion", 60.0, 30.0),
        _kernel(2, 14, "MemcpyH2D", 5.0, 2.0),
    ]}
    out = trace_giga.summarize(trace, top=1)
    assert set(out) == {"/device:GPU:0 Stream #13(Compute)",
                        "/device:GPU:0 Stream #14(MemcpyH2D)"}
    s = out["/device:GPU:0 Stream #13(Compute)"]
    assert s["events"] == 3 and s["busy_us"] == 70.0
    assert s["window_us"] == 90.0
    assert s["idle_share"] == pytest.approx(20.0 / 90.0)
    assert s["top"] == [["gemm_fusion", 60.0, 2]]


def test_summarize_empty_trace():
    assert trace_giga.summarize({"traceEvents": []}) == {}


def test_refuses_without_gpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_giga.py"), "--n", "64",
         "--out", str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
