"""High-level one-call training API.

``minimize`` is the front door for the fused engine: give it a JAX loss,
an initial point (flat vector or pytree), and batched data; it builds the
optimizer, runs fused epochs on the accelerator, and returns the result —
the on-device counterpart of the reference's guided ``fit`` loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.fused import FusedTrainer, batchify
from stochqn_tpu.optax_adapter import PytreeTrainer
from stochqn_tpu.utils.metrics import LossHistory, summarize_infos

_CONFIGS = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig, "adaQN": AdaQNConfig}


@dataclasses.dataclass
class MinimizeResult:
    x: Any                  # optimized parameters (same structure as x0)
    state: Any              # final optimizer state (checkpointable pytree)
    losses: list            # per-epoch full-data loss (if obj evaluated)
    info_counts: dict       # histogram of iteration info codes
    nepochs_run: int


def minimize(loss_fn: Callable, x0, data, *, optimizer: str = "adaQN",
             step_size: float = 1e-1, batch_size: Optional[int] = None,
             nepochs: int = 25, decr_step_size=None, tol: Optional[float] = None,
             shuffle_key=None, mesh=None, **optimizer_kwargs) -> MinimizeResult:
    """Stochastically minimize ``loss_fn`` over batched data.

    Args:
      loss_fn: ``loss_fn(x, batch) -> scalar`` (JAX-traceable); ``x`` has
        the structure of ``x0`` (flat array or pytree).
      x0: initial parameters.
      data: pytree of arrays — either already batched ``[B, bs, ...]`` (use
        ``batch_size=None``) or example-major ``[N, ...]`` with
        ``batch_size`` given.
      optimizer: "oLBFGS" | "SQN" | "adaQN".
      tol: optional early-stop threshold on the epoch loss decrease
        (guided-driver semantics).
      mesh: optional ``jax.sharding.Mesh`` — state and batches are placed
        for data-parallel (+ param-sharded) execution.
      **optimizer_kwargs: forwarded to the optimizer config
        (``mem_size``, ``bfgs_upd_freq``, ``max_incr``, ...).
    """
    if optimizer not in _CONFIGS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    cfg = _CONFIGS[optimizer].create(**optimizer_kwargs)

    if batch_size is not None:
        data = batchify(data, batch_size)

    is_pytree = not (hasattr(x0, "ndim") and getattr(x0, "ndim", None) == 1)
    if is_pytree:
        trainer = PytreeTrainer(optimizer, cfg, loss_fn, x0)
        state = trainer.init(x0)
        flat_loss = trainer.trainer.obj_fn
    else:
        def grad_fn(x, batch):
            return jax.grad(loss_fn)(x, batch)
        trainer = FusedTrainer(optimizer, cfg, grad_fn, obj_fn=loss_fn)
        state = trainer.init(jnp.asarray(x0))
        flat_loss = loss_fn

    if mesh is not None:
        from stochqn_tpu.parallel import shard_batches, shard_state
        state = shard_state(state, mesh)
        data = shard_batches(data, mesh)

    epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
    upd_freq = getattr(trainer.cfg, "upd_freq", 1)

    def full_loss(st):
        from stochqn_tpu.fused import _flat
        return float(flat_loss(st.x, _flat(data)))

    history = LossHistory(tol if tol is not None else float("inf"))
    all_infos = []
    epochs_run = 0
    losses = []
    # one D2H read; niter advances by num_batches per epoch (tracked
    # host-side so epoch dispatch is not serialized by a per-epoch sync)
    niter = int(state.niter)
    num_batches = jax.tree_util.tree_leaves(data)[0].shape[0]
    for epoch in range(nepochs):
        eta = (step_size if decr_step_size is None
               else decr_step_size(step_size, epoch))
        d = data
        if shuffle_key is not None:
            from stochqn_tpu.fused import shuffle_batched
            shuffle_key, sub = jax.random.split(shuffle_key)
            d = shuffle_batched(data, sub)
        state, infos = epoch_fn(state, d, eta,
                                aligned=niter % upd_freq == 0)
        niter += num_batches
        all_infos.append(infos)
        epochs_run += 1
        if tol is not None:
            loss = full_loss(state)
            losses.append(loss)
            if history.update(loss):
                break

    x_out = (trainer.params(state) if is_pytree else state.x)
    return MinimizeResult(
        x=x_out, state=state, losses=losses,
        info_counts=summarize_infos(jnp.stack(all_infos)),
        nepochs_run=epochs_run)
