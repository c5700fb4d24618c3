"""Multi-host initialization.

The reference is strictly single-process (SURVEY.md §2.5).  Across hosts,
JAX's standard multi-controller model applies: every host runs the same
program, ``initialize()`` wires up the global device view, and all the
sharded paths in this package (``build_sharded``, ``run_nuts_sharded``,
``dryrun_multichip``) work unchanged — NamedSharding axes spanning hosts
make XLA route collectives over DCN automatically.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> int:
    """Initialize jax.distributed (no-op if already initialized or single
    process).  Returns the global device count.

    JAX auto-detects the arguments only on clusters it recognises (SLURM,
    for one); pass them explicitly elsewhere.
    """
    if coordinator_address is not None or num_processes not in (None, 1):
        # NOTE: probing jax.process_count() here would itself initialize the
        # XLA backend and make jax.distributed.initialize impossible — the
        # idempotence check must go through the distributed runtime state,
        # which raises a recognizable error on double initialization.
        try:
            jax.distributed.initialize(coordinator_address=coordinator_address,
                                       num_processes=num_processes,
                                       process_id=process_id)
        except RuntimeError as e:
            if "already" not in str(e) and "once" not in str(e):
                raise
    return len(jax.devices())


def local_data_shard(n: int) -> slice:
    """Row range of a length-n dataset owned by this process under even
    data-parallel sharding (host-side data loading helper)."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n // p)
    return slice(i * per, min((i + 1) * per, n))
