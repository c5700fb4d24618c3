"""The accelerator an entry point runs on.

``chip_smoke.py`` and ``bench.py`` measure the GPU and refuse to run
anywhere else: :func:`require_gpu` exits non-zero when JAX's first device is
not a GPU, and :func:`card_line` names the card and its power limit for
every printed number.
"""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu(ndev: int = 1):
    """The first JAX device, or exit non-zero: nothing here falls back to
    the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU (jax.devices()[0] is {devs[0].platform}); nothing "
              "was run", file=sys.stderr)
        raise SystemExit(2)
    if len(devs) < ndev:
        print(f"needs {ndev} GPUs, found {len(devs)}", file=sys.stderr)
        raise SystemExit(2)
    return devs[0]


def card_line() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
