"""Native (C++) host-side kernels.

The reference's only native code is hand-edited weighted Stan C++ (replaced
here by pure-JAX weighted NUTS) plus scipy's Fortran Lawson-Hanson NNLS
(reference snnls/snnls.py:87).  This package provides a from-scratch C++
Lawson-Hanson solver compiled on first use (g++, cached in the user cache
dir) and loaded through ctypes — no Fortran, no scipy requirement on the
host path.  All device-side solves use the on-device FISTA solver (ops/nnls.py);
this exact solver backs host ``optimize()`` paths and serves as a
correctness oracle in tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "nnls.cpp")
_lib = None
_load_error: str | None = None


def _build_and_load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        cache_dir = os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "bayesian_coresets_tpu")
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"libbcnnls-{tag}.so")
        if not os.path.exists(so_path):
            tmp = tempfile.mktemp(suffix=".so", dir=cache_dir)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.bc_nnls.restype = ctypes.c_int
        lib.bc_nnls.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    except Exception as e:  # no compiler / load failure: callers fall back
        _load_error = f"{type(e).__name__}: {e}"


def available() -> bool:
    _build_and_load()
    return _lib is not None


def nnls(A: np.ndarray, b: np.ndarray, maxiter: int | None = None):
    """Exact NNLS via the native Lawson-Hanson solver.

    A: (m, n); b: (m,).  Returns (x, rnorm) like scipy.optimize.nnls.
    Raises RuntimeError if the native library is unavailable or the solve
    fails; callers may fall back to the on-chip FISTA solver.
    """
    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native nnls unavailable: {_load_error}")
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    m, n = A.shape
    if b.shape != (m,):
        raise ValueError(f"shape mismatch: A {A.shape}, b {b.shape}")
    x = np.zeros(n, np.float64)
    rnorm = np.zeros(1, np.float64)
    code = _lib.bc_nnls(
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m, n, -1 if maxiter is None else int(maxiter),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rnorm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if code == 1:
        raise RuntimeError("native nnls: maxiter reached")
    if code == 2:
        raise RuntimeError("native nnls: numerical failure (singular passive set)")
    return x, float(rnorm[0])
