"""Per-step budget sweeps for adaQN and oLBFGS on the flagship workload.

Answers two "where does the time go" questions:

* adaQN: does per-step time scale with ``fisher_size``?  (If strongly —
  the in-scan Fisher append would be copying the whole
  ``[fisher_size, n]`` buffer.)
* oLBFGS: does per-step time scale with ``mem_size``?  (If yes — the
  commit-time batched ``[2, m, m]`` Neumann chain would be the
  bottleneck.)

Chained-state timing with ``block_until_ready`` per rep.  One process per
card.  Not yet run on the H100.
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

NF, K, BS, B, L = 1836, 159, 50, 120, 20


def _data():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((B, BS, NF)), jnp.float32)
    labels = rng.integers(0, K, (B, BS))
    Y = jnp.asarray(np.eye(K)[labels], jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((NF + 1) * K), jnp.float32)
    return X, Y, x0


def _grad_fn(x, batch):
    Xb, Yb = batch
    return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)


def _obj_fn(x, batch):
    Xb, Yb = batch
    return losses.multinomial_logistic_loss(x, Xb, Yb, None, 1e-1)


def _time(trainer, x0, X, Y, eta):
    state = trainer.init(x0)
    ep = jax.jit(trainer.epoch, static_argnames=("aligned",))
    for _ in range(2):          # warmup: compile + steady-state caches
        state, _ = ep(state, (X, Y), eta, aligned=True)
    float(jnp.sum(state.x))     # D2H barrier
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            state, _ = ep(state, (X, Y), eta, aligned=True)
        float(jnp.sum(state.x))
        reps.append((time.perf_counter() - t0) / 5)
    return statistics.median(reps)


def main():
    X, Y, x0 = _data()
    print("adaQN fisher_size sweep (empirical Fisher + RMSProp H0):")
    for fs in (4, 25, 100):
        tr = FusedTrainer(
            "adaQN",
            AdaQNConfig.create(mem_size=10, fisher_size=fs,
                               bfgs_upd_freq=L, rmsprop_weight=0.9),
            _grad_fn, obj_fn=_obj_fn)
        dt = _time(tr, x0, X, Y, jnp.float32(1e-1))
        print(f"  fisher_size={fs:4d}  {B/dt:8.0f} iters/s"
              f"  ({dt/B*1e6:7.1f} us/step)", flush=True)

    print("oLBFGS mem_size sweep (pair commit every iteration):")
    for m in (2, 5, 10):
        tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=m),
                          _grad_fn)
        dt = _time(tr, x0, X, Y, jnp.float32(1e-2))
        print(f"  mem_size={m:3d}    {B/dt:8.0f} iters/s"
              f"  ({dt/B*1e6:7.1f} us/step)", flush=True)


if __name__ == "__main__":
    main()
