"""Utility subsystem: tolerances, PRNG discipline, logging, tree helpers.

JAX re-design of the reference's ``bayesiancoresets/util`` package
(reference: util/__init__.py:4-7, util/log.py:5-42, util/errors.py:1).
Instead of a module-global mutated by ``set_tolerance`` and exception-based
control flow (``NumericalPrecisionError``), numeric-limit detection inside
jitted solver loops is branchless (status flags in the carry); the tolerance
is an explicit config value so compiled code never closes over mutable
globals.
"""

from . import cache, checkpoint, device, profiling
from .cache import enable_compilation_cache
from .device import card_line, require_gpu
from .config import TOL, get_tolerance, set_tolerance, default_dtype
from .errors import NumericalPrecisionError
from .log import get_logger, set_verbosity
from .prng import fold_seed, split_like

__all__ = [
    "cache",
    "card_line",
    "checkpoint",
    "device",
    "enable_compilation_cache",
    "profiling",
    "require_gpu",
    "TOL",
    "get_tolerance",
    "set_tolerance",
    "default_dtype",
    "NumericalPrecisionError",
    "get_logger",
    "set_verbosity",
    "fold_seed",
    "split_like",
]
