"""Worker process for the multi-controller (2-process) distributed test.

Each OS process owns 2 virtual CPU devices; ``jax.distributed.initialize``
(via parallel.distributed.initialize) wires them into one 4-device global
view, and a data-parallel GIGA build runs over a global mesh — the
collectives cross the process boundary through the distributed runtime,
exactly as they would cross the network between hosts.

Usage: python distributed_worker.py <pid> <nproc> <coordinator> <outdir>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesian_coresets_tpu.parallel import build_sharded, make_mesh  # noqa: E402
from bayesian_coresets_tpu.parallel import distributed  # noqa: E402


def main():
    pid, nproc, coordinator, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
    ndev = distributed.initialize(coordinator, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert ndev == 2 * nproc, ndev

    # local_data_shard must partition [0, n) evenly across processes
    n = 4096
    sl = distributed.local_data_shard(n)
    assert sl == slice(pid * (n // nproc), (pid + 1) * (n // nproc)), sl

    # identical problem constructed on every host (multi-controller SPMD)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, n)).astype(np.float32)
    b = A.sum(axis=1)

    mesh = make_mesh({"data": ndev})  # spans both processes
    st = build_sharded(A, b, 64, mesh, max_active=128)
    w = np.asarray(multihost_utils.process_allgather(st.w, tiled=True))
    np.save(os.path.join(outdir, f"w_{pid}.npy"), w)
    print(f"process {pid}: done, nnz={int((w > 0).sum())}")

    # ---- streamed int8-resident construction, multi-controller ----------
    # each process passes ONLY its streamed_row_layout rows; projection
    # runs SPMD (every device projects its own rows), and the build runs
    # on the resulting sharded consts.  No process ever holds the full
    # int8 matrix.
    import jax.numpy as jnp
    from bayesian_coresets_tpu.ops import snnls as S
    from bayesian_coresets_tpu.parallel import (make_streamed_quantized_consts,
                                                streamed_row_layout)

    n2, d2 = 3000, 6
    rng2 = np.random.default_rng(1)
    full = rng2.normal(size=(n2, d2)).astype(np.float32)   # same on every host
    ths = jnp.asarray(rng2.normal(size=(16, d2)).astype(np.float32))
    project = lambda pts: jnp.tanh(pts @ ths.T)            # fixed-context
    _, _, _, sl = streamed_row_layout(n2, mesh)
    consts = make_streamed_quantized_consts(full[sl], project, 512, mesh, n2)
    alg = S.GIGA.from_consts(consts, seed=0, max_active=64, mesh=mesh)
    alg.build(40)
    idx, vals = alg.active()
    np.save(os.path.join(outdir, f"stream_idx_{pid}.npy"), idx)
    np.save(os.path.join(outdir, f"stream_w_{pid}.npy"), vals)
    print(f"process {pid}: streamed done, active={int((vals > 0).sum())}")


if __name__ == "__main__":
    main()
