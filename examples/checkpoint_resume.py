"""Checkpoint / resume through the fused engine, mid-protocol.

The whole optimizer state — pair ring buffers, Fisher memory, averages,
accumulators, and the ``section`` coroutine resume point — is one JAX
pytree, so a snapshot taken at ANY iteration (even mid-round, between two
correction-pair boundaries) restores exactly: the resumed run reproduces
the uninterrupted trajectory bit-for-bit on the same backend.

The reference has no serialization API (its state lives in Python/R holder
objects one could pickle by hand, ``stochqn/_optimizers.py:791-879``);
here it is a first-class, tested capability (``utils/checkpoint.py``:
a dependency-free .npz format).

Run: python examples/checkpoint_resume.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Tiny demo problem: CPU is the right tool (see rosenbrock_free_mode.py).
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import AdaQNConfig
from stochqn_tpu.fused import FusedTrainer, batchify
from stochqn_tpu.utils.checkpoint import load_state, save_state


def main():
    rng = np.random.default_rng(0)
    n, rows, bs = 32, 240, 8
    w_true = rng.standard_normal(n)
    X = rng.standard_normal((rows, n)).astype(np.float32)
    y = (X @ w_true + 0.05 * rng.standard_normal(rows)).astype(np.float32)
    data = batchify((jnp.asarray(X), jnp.asarray(y)), bs)

    def grad_fn(w, batch):
        Xb, yb = batch
        return Xb.T @ (Xb @ w - yb) / Xb.shape[0]

    def obj_fn(w, batch):
        Xb, yb = batch
        return 0.5 * jnp.mean((Xb @ w - yb) ** 2)

    trainer = FusedTrainer(
        "adaQN", AdaQNConfig.create(mem_size=5, bfgs_upd_freq=4,
                                    fisher_size=16, max_incr=1.01),
        grad_fn, obj_fn=obj_fn)
    epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))

    loss0 = float(obj_fn(jnp.zeros(n), (jnp.asarray(X), jnp.asarray(y))))
    print(f"initial full-data loss = {loss0:.6f}")

    # --- uninterrupted run: 4 epochs -----------------------------------
    state = trainer.init(jnp.zeros(n))
    for _ in range(4):
        state, _ = epoch(state, data, 0.1, aligned=True)
    x_full = np.asarray(state.x)

    # --- interrupted run: 2 epochs, checkpoint, restart, 2 more --------
    state = trainer.init(jnp.zeros(n))
    for _ in range(2):
        state, _ = epoch(state, data, 0.1, aligned=True)
    ckpt = os.path.join(tempfile.mkdtemp(prefix="sqn_ckpt_"), "state.npz")
    save_state(ckpt, state)
    print(f"checkpointed at iteration {int(state.niter)} -> {ckpt}")

    resumed = load_state(ckpt, trainer.init(jnp.zeros(n)))  # fresh template
    assert int(resumed.niter) == int(state.niter)
    for _ in range(2):
        resumed, _ = epoch(resumed, data, 0.1, aligned=True)
    x_resumed = np.asarray(resumed.x)

    diff = float(np.max(np.abs(x_full - x_resumed)))
    loss = float(obj_fn(resumed.x, (jnp.asarray(X), jnp.asarray(y))))
    print(f"max |x_full - x_resumed| = {diff:.2e}  (bitwise resume)")
    print(f"final full-data loss = {loss:.6f}")
    assert diff == 0.0, "resume diverged from the uninterrupted run"
    print("OK")


if __name__ == "__main__":
    main()
