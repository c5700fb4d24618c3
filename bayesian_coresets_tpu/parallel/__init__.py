"""Distributed/parallel subsystem: meshes, sharded construction, sharded chains.

The answer to SURVEY.md §2.5 (the reference is single-process): DP
over dataset rows, TP over the projection dimension, chain parallelism for
MCMC; collectives are inserted by XLA from sharding annotations.
"""

from .coreset import (build_sharded, build_sharded_quantized,
                      shard_consts, shard_state)
from .distributed import initialize, local_data_shard
from .mcmc import run_nuts_sharded
from .mesh import CHAIN_AXIS, DATA_AXIS, PROJ_AXIS, data_sharding, make_mesh, replicated
from .streamed import (make_sharded_stream_step, make_streamed_quantized_consts,
                       streamed_row_layout)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "DATA_AXIS",
    "PROJ_AXIS",
    "CHAIN_AXIS",
    "build_sharded",
    "build_sharded_quantized",
    "shard_consts",
    "shard_state",
    "run_nuts_sharded",
    "initialize",
    "local_data_shard",
    "make_sharded_stream_step",
    "make_streamed_quantized_consts",
    "streamed_row_layout",
]
