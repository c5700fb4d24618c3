"""Model subsystem: batched log-densities, gradients, conjugate closed forms.

JAX re-design of the reference's ``examples/common/model_*.py``
modules (model_gaussian.py, model_linreg.py, model_lr.py, model_poiss.py).
Every function is pure, jittable, and batched over both data (n) and
posterior samples (S) so the (n x S) log-likelihood discretization used by
the projectors is a single fused matmul+elementwise graph.
"""

from . import gaussian, linreg, logistic, poisson
from .laplace import laplace_approx, LaplaceResult

__all__ = ["gaussian", "linreg", "logistic", "poisson", "laplace_approx", "LaplaceResult"]
