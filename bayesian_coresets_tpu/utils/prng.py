"""PRNG discipline helpers.

The reference relies on a single global NumPy stream seeded per trial
(reference: examples/gaussian/main.py:44).  This framework threads
``jax.random`` keys explicitly; these helpers keep per-trial reproducibility
independent of device/host count.
"""

from __future__ import annotations

import jax


def fold_seed(trial: int, *tags: int) -> jax.Array:
    """Derive a reproducible key from an integer trial id plus stage tags."""
    key = jax.random.key(trial)
    for t in tags:
        key = jax.random.fold_in(key, t)
    return key


def split_like(key: jax.Array, n: int) -> jax.Array:
    """Split a key into ``n`` keys (thin wrapper kept for call-site clarity)."""
    return jax.random.split(key, n)
