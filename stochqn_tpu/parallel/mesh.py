"""Device mesh construction and state sharding for multi-chip execution.

The reference's only parallelism is OpenMP threads + a threaded BLAS
(``src/stochqn.c:144-292``); its math, however, is naturally data-parallel
(every external request is a sample mean over a batch) and parameter-
separable (flat ``x[n]``).  This module maps both axes onto a JAX device
mesh:

  * ``data`` axis: minibatches / big-batch correction sets are sharded by
    example; gradients, empirical-Fisher terms and function values reduce
    with one ``psum`` (NCCL over NVLink between the GPUs of a host).
  * ``param`` axis: for very large ``n``, the iterate and the ``[m, n]``
    pair/Fisher memories shard along ``n``; the compact two-loop then needs
    exactly one fused ``psum`` of ``O(m^2)`` scalars per step (see
    :mod:`stochqn_tpu.ops.two_loop`).

Everything here produces ``NamedSharding``s and relies on jit/GSPMD to
insert the collectives — no hand-written communication.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
PARAM_AXIS = "param"


def make_mesh(n_data: Optional[int] = None, n_param: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, param)`` mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_param
    if n_data * n_param != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_param} does not match {len(devices)} devices")
    arr = np.asarray(devices).reshape(n_data, n_param)
    return Mesh(arr, (DATA_AXIS, PARAM_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the trailing (parameter) axis over the ``param`` mesh axis."""
    spec = [None] * ndim
    spec[-1] = PARAM_AXIS
    return NamedSharding(mesh, P(*spec))


def batch_sharding(mesh: Mesh, ndim: int, example_axis: int = 0
                   ) -> NamedSharding:
    """Shard the example axis over the ``data`` mesh axis."""
    spec = [None] * ndim
    spec[example_axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


# Fields whose trailing dimension is the parameter count ``n``.  Matching on
# names (leaf paths) rather than on shape avoids accidentally sharding the
# O(m)/O(m^2) small-math caches (gram, bwd_inv, c0, ...) when a small model
# happens to have n == mem_size or n == 2*mem_size, which would add needless
# per-step collectives.
_PARAM_AXIS_FIELDS = frozenset({
    "x", "s", "y", "sy", "s_pending", "f", "grad_prev",
    "x_sum", "x_avg_prev", "grad_sum_sq",
})


def shard_state(state, mesh: Mesh):
    """Place an optimizer state pytree on the mesh: parameter-axis arrays
    sharded over ``param``, everything else (scalars, indices, the small-math
    caches) replicated.

    Works for all three state dataclasses: leaves are selected by field name
    (:data:`_PARAM_AXIS_FIELDS`), so the selection is independent of whether
    ``n`` collides with a memory-sized dimension.
    """

    def place(path, leaf):
        name = path[-1].name if path and hasattr(path[-1], "name") else None
        if name in _PARAM_AXIS_FIELDS and leaf.ndim >= 1:
            return jax.device_put(leaf, param_sharding(mesh, leaf.ndim))
        return jax.device_put(leaf, replicated(mesh))

    return jax.tree_util.tree_map_with_path(place, state)


def epoch_batch_constraint(mesh: Mesh, example_axis: int = 1):
    """Sharding constraint for the fused scheduled-dispatch epoch data.

    Returns a callable for ``FusedTrainer.batch_constraint``: inside the
    ``jit_epochs_scheduled`` scan body it pins each rebatched leaf's
    within-batch example axis (axis 1 of ``[B, bs, ...]``) onto the
    ``data`` mesh axis, restoring data-parallel gradient compute after the
    device-side shuffle gather (whose output GSPMD otherwise replicates —
    see the field comment in :class:`stochqn_tpu.fused.FusedTrainer`).
    Other axes stay UNCONSTRAINED so the parameter axis keeps whatever
    sharding propagates from the state.
    """
    U = P.UNCONSTRAINED

    def constrain(data):
        def one(leaf):
            spec = [U] * leaf.ndim
            spec[0] = None                    # batch-count axis: scan-sliced
            spec[example_axis] = DATA_AXIS
            return jax.lax.with_sharding_constraint(
                leaf, NamedSharding(mesh, P(*spec)))
        return jax.tree_util.tree_map(one, data)

    return constrain


def shard_batches(data, mesh: Mesh, batched: bool = True):
    """Place pre-batched data (leaves ``[B, bs, ...]``) with the within-batch
    example axis sharded over ``data`` (or axis 0 when ``batched=False``)."""
    axis = 1 if batched else 0

    def place(leaf):
        return jax.device_put(leaf, batch_sharding(mesh, leaf.ndim, axis))

    return jax.tree_util.tree_map(place, data)
