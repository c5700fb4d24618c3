"""Global numeric configuration.

The reference keeps a module-global ``TOL = 1e-12`` with a ``set_tolerance``
mutator (reference: bayesiancoresets/util/__init__.py:4-7).  We keep the same
user-facing API, but the default is sized for float32 device arithmetic
rather than float64 CPU arithmetic; jitted solvers take the tolerance as a traced
scalar argument so changing it never triggers recompilation.
"""

from __future__ import annotations

import jax.numpy as jnp

# Relative slack used by error-monotonicity checks; f32 epsilon is ~1.2e-7 so
# 1e-12 (the reference's f64 default) would reject virtually every step.
TOL: float = 1e-6


def set_tolerance(tol: float) -> None:
    """Set the library-wide numerical tolerance (reference util/__init__.py:6-7)."""
    global TOL
    if tol < 0:
        raise ValueError(f"tolerance must be nonnegative, got {tol}")
    TOL = float(tol)


def get_tolerance() -> float:
    return TOL


def default_dtype() -> jnp.dtype:
    """Compute dtype for solver internals.

    float32: the coreset algorithms are precision-sensitive (geodesic
    directions, error monotonicity), so we do not downcast below f32; matmuls
    request ``preferred_element_type=float32`` so they accumulate in f32.
    """
    return jnp.float32
