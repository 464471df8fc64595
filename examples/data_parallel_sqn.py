"""Streaming data-parallel SQN on a Criteo-style CTR logistic regression.

BASELINE config 5: large sparse click-through-rate data, hashed into a
dense feature space, minibatches sharded across the device mesh's ``data``
axis.  Gradients / Hessian-vector products reduce with a single psum
(inserted automatically by GSPMD from the sharding annotations).

Run on CPU with a virtual mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/data_parallel_sqn.py
or on a machine with several GPUs unchanged.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses
from stochqn_tpu.parallel import make_mesh, shard_batches, shard_state

HASH_DIM = 4096          # hashed feature space (Criteo-style trick)
FIELDS = 39              # raw categorical fields per example
BATCH = 512
NUM_BATCHES = 64


def make_stream(rng, num_batches):
    """Synthetic CTR stream: each example has FIELDS hashed indices."""
    idx = rng.integers(0, HASH_DIM, (num_batches, BATCH, FIELDS))
    w_true = rng.standard_normal(HASH_DIM) * 0.3
    X = np.zeros((num_batches, BATCH, HASH_DIM), np.float32)
    for b in range(num_batches):
        for f in range(FIELDS):
            X[b, np.arange(BATCH), idx[b, :, f]] += 1.0
    logits = X.reshape(-1, HASH_DIM) @ w_true
    y = (rng.random(logits.shape) < 1 / (1 + np.exp(-logits))).astype(
        np.float32)
    return (jnp.asarray(X),
            jnp.asarray(2 * y.reshape(num_batches, BATCH) - 1))


def main():
    rng = np.random.default_rng(0)
    X, y = make_stream(rng, NUM_BATCHES)
    x0 = jnp.zeros(HASH_DIM + 1, jnp.float32)

    def grad_fn(x, batch):
        Xb, yb = batch
        return losses.binary_logistic_grad(x, Xb, yb, None, 1e-6)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=8), grad_fn)
    state = trainer.init(x0)

    ndev = len(jax.devices())
    mesh = make_mesh(n_data=ndev, n_param=1)
    state = shard_state(state, mesh)
    X, y = shard_batches((X, y), mesh)
    print(f"mesh: {mesh}")

    epoch = jax.jit(trainer.epoch)
    for e in range(3):
        t0 = time.perf_counter()
        state, _ = epoch(state, (X, y), jnp.float32(0.5))
        jax.block_until_ready(state.x)
        loss = float(losses.binary_logistic_loss(
            state.x, X.reshape(-1, HASH_DIM), y.reshape(-1), None, 1e-6))
        print(f"epoch {e}: loss/row {loss/(NUM_BATCHES*BATCH):.4f}  "
              f"({NUM_BATCHES/(time.perf_counter()-t0):.0f} iters/s)")


if __name__ == "__main__":
    main()
