"""MCMC subsystem: weighted-likelihood NUTS/HMC in pure JAX.

Pure-JAX replacement for the reference's pystan + hand-edited weighted
Stan C++ (SURVEY.md §2.2 C20/C21, §2.4): the weight vector enters the
jittable log-density directly, chains are vmapped/shardable, and the
sampler compiles once per model.
"""

from .adapt import build_schedule, da_init, da_update, find_reasonable_step_size
from .diagnostics import ess, split_rhat
from .hmc import hmc_kernel
from .integrators import (IntegratorState, kinetic, leapfrog, mass_mul,
                          sample_momentum)
from .nuts import NUTSInfo, nuts_kernel
from .sample import MCMCResult, run_nuts
from .weighted import run, weighted_logdensity

__all__ = [
    "IntegratorState",
    "leapfrog",
    "kinetic",
    "mass_mul",
    "sample_momentum",
    "nuts_kernel",
    "NUTSInfo",
    "hmc_kernel",
    "run_nuts",
    "MCMCResult",
    "run",
    "weighted_logdensity",
    "ess",
    "split_rhat",
    "find_reasonable_step_size",
]
