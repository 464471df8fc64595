"""Multi-host initialization and mesh construction.

The reference is single-process (its only parallelism is OpenMP threads).
Scaling here is mesh-native: on several hosts (or several processes on
one), call :func:`initialize` once per process, then build a global mesh
spanning all of them.  All collectives ride XLA (NCCL over NVLink between
the GPUs of a host, the network between hosts, Gloo between CPU
processes) — no custom transport, mirroring the SURVEY §2 mapping.  One
process drives all the GPUs of one host without this module.
"""
from __future__ import annotations

from typing import Optional

import jax

from stochqn_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (no-op on single process).

    Where a cluster manager describes the job, JAX may detect the
    arguments; elsewhere pass the coordinator (``localhost:<port>`` on one
    machine), the process count and this process's id.  Must be called
    before any jax operation.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if (num_processes is None and coordinator_address is None
            and process_id is None):
        # default call: auto-detect a managed cluster (e.g. SLURM);
        # genuinely single-process environments are a no-op
        try:
            jax.distributed.initialize()
        except Exception:
            return
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(n_param: int = 1):
    """Mesh over every addressable device across all processes, with the
    ``data`` axis spanning hosts (pure-DP default) and an optional
    ``param`` axis for large-n sharding."""
    return make_mesh(n_param=n_param, devices=jax.devices())


def process_local_batch_slice(global_batch_size: int) -> slice:
    """Row slice of the global batch this process should load — equal
    shards per process, reference-free streaming ingestion."""
    per = global_batch_size // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)


def global_batches(local_data, mesh, batched: bool = True):
    """Assemble GLOBAL device arrays from per-process batch slices.

    The multi-process counterpart of :func:`stochqn_tpu.parallel.mesh.
    shard_batches` (which ``device_put``s host data it assumes every
    process holds in full): here each process supplies only its
    ``process_local_batch_slice`` of the example axis, and
    ``jax.make_array_from_process_local_data`` stitches the global
    sharded array together — rows never leave the process that loaded
    them.  Leaves are ``[B, bs_local, ...]`` (``batched=True``) or
    ``[rows_local, ...]``.
    """
    import numpy as np

    from stochqn_tpu.parallel.mesh import batch_sharding

    axis = 1 if batched else 0

    def place(leaf):
        leaf = np.asarray(leaf)
        sharding = batch_sharding(mesh, leaf.ndim, axis)
        global_shape = list(leaf.shape)
        global_shape[axis] *= jax.process_count()
        return jax.make_array_from_process_local_data(
            sharding, leaf, tuple(global_shape))

    return jax.tree_util.tree_map(place, local_data)


def shard_state_global(state, mesh):
    """Multi-process counterpart of :func:`stochqn_tpu.parallel.mesh.
    shard_state`: place an optimizer state on a mesh that spans processes,
    parameter-axis arrays sharded over ``param`` and everything else
    replicated.

    Each process holds the full state host-side (states are small next to
    data); ``jax.make_array_from_callback`` hands every device exactly its
    shard, which is required because ``jax.device_put`` cannot target
    devices another process owns.
    """
    import numpy as np

    from stochqn_tpu.parallel.mesh import (_PARAM_AXIS_FIELDS,
                                           param_sharding, replicated)

    def place(path, leaf):
        name = path[-1].name if path and hasattr(path[-1], "name") else None
        arr = np.asarray(leaf)
        if name in _PARAM_AXIS_FIELDS and arr.ndim >= 1:
            sharding = param_sharding(mesh, arr.ndim)
        else:
            sharding = replicated(mesh)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx, a=arr: a[idx])

    return jax.tree_util.tree_map_with_path(place, state)


def replicate_global(value, mesh):
    """Build a fully-replicated global array from identical per-process
    host data (e.g. the initial iterate): multi-process jit requires
    global arrays even for replicated operands."""
    import numpy as np

    from stochqn_tpu.parallel.mesh import replicated

    def place(leaf):
        leaf = np.asarray(leaf)
        return jax.make_array_from_process_local_data(
            replicated(mesh), leaf, leaf.shape)

    return jax.tree_util.tree_map(place, value)
