"""Persistent XLA compilation cache for the entry points.

``chip_smoke.py``, ``bench.py`` and the experiment drivers call
:func:`enable_compilation_cache` once before compiling anything.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at one fixed directory inside the
checkout (``.jax_cache``, listed in ``.gitignore``): the path is part of
the cache key, so it must not depend on a temporary name, a process id or
the time.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
