"""Device-time breakdown of one GIGA Hilbert coreset build on a GPU.

Builds the README quickstart's coreset (logistic regression, d=10, Laplace
projector with S=500, int8 selection copy, M=500) at ``--n`` points, runs
the build once to compile, then traces one more build with
``jax.profiler``.  For every GPU stream in the trace it prints the kernel
count, the busy time, the traced window, the idle share and the kernels
that take the most time.

Run from the repository root on a machine with a GPU:

    python scripts/trace_giga.py [--n 1000000] [--out build/trace_giga]

The raw trace stays under ``--out``.  Every line names the card and its
power limit; the last line of standard output is the JSON summary.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the data are made on the host CPU device: keep that backend available
# when the environment names the accelerator platform alone
_PLATFORMS = os.environ.get("JAX_PLATFORMS", "")
if _PLATFORMS and "cpu" not in _PLATFORMS.split(","):
    os.environ["JAX_PLATFORMS"] = _PLATFORMS + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bayesian_coresets_tpu as bc  # noqa: E402
from bayesian_coresets_tpu.models import logistic  # noqa: E402
from bayesian_coresets_tpu.models.laplace import (laplace_approx,  # noqa: E402
                                                  sample_laplace)
from bayesian_coresets_tpu.utils import (card_line,  # noqa: E402
                                         enable_compilation_cache,
                                         require_gpu)


def summarize(trace: dict, top: int = 12) -> dict:
    """Per GPU stream of a Chrome-format trace: kernel count, busy and
    window microseconds, idle share, and the ``top`` kernels by time as
    [name, microseconds, count]."""
    events = trace.get("traceEvents", [])
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    threads = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    streams: dict = {}
    for e in events:
        proc = procs.get(e.get("pid"), "")
        if e.get("ph") != "X" or not proc.startswith("/device:GPU"):
            continue
        key = f"{proc} {threads.get((e['pid'], e['tid']), e['tid'])}"
        s = streams.setdefault(key, {"events": 0, "busy_us": 0.0,
                                     "t0": float("inf"), "t1": float("-inf"),
                                     "by_name": {}})
        dur = float(e.get("dur", 0.0))
        s["events"] += 1
        s["busy_us"] += dur
        s["t0"] = min(s["t0"], float(e["ts"]))
        s["t1"] = max(s["t1"], float(e["ts"]) + dur)
        tot, cnt = s["by_name"].get(e["name"], (0.0, 0))
        s["by_name"][e["name"]] = (tot + dur, cnt + 1)
    out = {}
    for key, s in streams.items():
        window = s["t1"] - s["t0"]
        ranked = sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])
        out[key] = {"events": s["events"], "busy_us": s["busy_us"],
                    "window_us": window,
                    "idle_share": 1.0 - s["busy_us"] / window if window > 0 else None,
                    "top": [[k, v[0], v[1]] for k, v in ranked[:top]]}
    return out


def load_trace(out_dir: str) -> dict:
    """The newest ``*.trace.json.gz`` that ``jax.profiler.trace`` wrote."""
    paths = glob.glob(os.path.join(out_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--M", type=int, default=500)
    ap.add_argument("--out", default=os.path.join("build", "trace_giga"))
    args = ap.parse_args(argv)

    dev = require_gpu()
    card = card_line()
    print(card, flush=True)
    enable_compilation_cache()

    d, S = 10, 500
    # the data are made on the host CPU, as chip_smoke.py makes them: at
    # --n 1000000 the traced build is the one its phase 1 checks
    with jax.default_device(jax.devices("cpu")[0]):
        Z = np.asarray(logistic.gen_synthetic(jax.random.key(0), args.n, d))
    lap = laplace_approx(jnp.asarray(Z), jnp.ones(args.n), jnp.zeros(d),
                         grad_fn=logistic.grad_th_log_joint,
                         hess_fn=logistic.hess_th_log_joint)
    sampler = lambda key, n, wts, pts: sample_laplace(key, lap, n)
    c = bc.HilbertCoreset(Z, bc.BlackBoxProjector(sampler, S,
                                                  logistic.log_likelihood),
                          select_dtype=jnp.int8)
    c.build(args.M)                                   # compile + warm
    c.reset()
    jax.block_until_ready(c.snnls.state)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        c.build(args.M)
        jax.block_until_ready(c.snnls.state)
    wall = time.perf_counter() - t0
    itrs = int(c.snnls.state.itr)
    streams = summarize(load_trace(args.out))
    for key, s in streams.items():
        print(json.dumps({"card": card, "stream": key, **s}), flush=True)
    print(json.dumps({"card": card, "platform": dev.platform,
                      "device_kind": dev.device_kind, "n": args.n, "M": args.M,
                      "iterations": itrs, "traced_build_s": wall,
                      "ms_per_iteration_traced": 1e3 * wall / max(itrs, 1),
                      "streams": {k: {kk: s[kk] for kk in
                                      ("events", "busy_us", "window_us",
                                       "idle_share")}
                                  for k, s in streams.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
