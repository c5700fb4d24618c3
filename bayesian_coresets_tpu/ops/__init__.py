"""Numerical kernels: sparse NNLS solvers, on-chip NNLS, projected Adam.

JAX replacement for the reference's L1 layer
(``bayesiancoresets/snnls`` + ``bayesiancoresets/util/opt.py``); see
SURVEY.md §1/§2.1.
"""

from .nnls import nnls_active_set, nnls_gram, nnls_rows
from .opt import nn_opt
from .snnls import (
    GIGA,
    FrankWolfe,
    ImportanceSampling,
    OrthoPursuit,
    SNNLSConsts,
    SNNLSState,
    SparseNNLS,
    UniformSampling,
    build,
    init_state,
    make_consts,
    make_consts_quantized,
)

__all__ = [
    "GIGA",
    "FrankWolfe",
    "OrthoPursuit",
    "ImportanceSampling",
    "UniformSampling",
    "SparseNNLS",
    "SNNLSConsts",
    "SNNLSState",
    "build",
    "init_state",
    "make_consts",
    "make_consts_quantized",
    "nnls_active_set",
    "nnls_rows",
    "nnls_gram",
    "nn_opt",
]
