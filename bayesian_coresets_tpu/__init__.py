"""bayesian_coresets_tpu — a Bayesian-coreset inference engine in JAX.

A from-scratch JAX/XLA re-design with the full capability surface of
``trevorcampbell/bayesian-coresets`` (the reference; see SURVEY.md):

- Hilbert coresets via sparse non-negative least squares
  (GIGA / Frank-Wolfe / Orthogonal Pursuit / Importance / Uniform sampling)
- SparseVI greedy KL-minimizing coresets with Monte-Carlo gradients
- BatchPSVI pseudocoresets (joint weight + synthetic point optimization)
- Black-box and exact log-likelihood projectors
- Weighted-likelihood NUTS/HMC in pure JAX (replacing the reference's
  hand-edited Stan C++), Laplace approximations, closed-form conjugate
  posteriors
- Mesh-sharded data-parallel construction and multi-chain MCMC

Public API mirrors the reference package exports
(reference bayesiancoresets/__init__.py:1-2) so users of the reference can
switch with minimal friction, while every compute path is a pure-functional
jitted core with static shapes.
"""

from . import models, mcmc, ops, parallel, utils
from . import utils as util           # reference spelling: bc.util.set_verbosity
from .ops import snnls                # reference pattern: bc.snnls.GIGA (snnls/__init__.py:1-4)
from .coresets import (
    BatchPSVICoreset,
    Coreset,
    HilbertCoreset,
    SparseVICoreset,
    UniformSamplingCoreset,
)
from .coresets.projector import BlackBoxProjector, Projector
from .utils import set_tolerance, set_verbosity

__version__ = "0.1.0"

__all__ = [
    "models",
    "mcmc",
    "ops",
    "parallel",
    "utils",
    "util",
    "snnls",
    "Coreset",
    "HilbertCoreset",
    "SparseVICoreset",
    "BatchPSVICoreset",
    "UniformSamplingCoreset",
    "Projector",
    "BlackBoxProjector",
    "set_tolerance",
    "set_verbosity",
]
