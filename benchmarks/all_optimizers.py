"""End-to-end iters/s for all three optimizers and their storage/layout
variants on the BibTeX-shaped workload.  Chained-state timing.
"""
import os
import sys
import statistics
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

NF, K, BS, B, L = 1836, 159, 50, 120, 20


def main():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((B, BS, NF)), jnp.float32)
    labels = rng.integers(0, K, (B, BS))
    Y = jnp.asarray(np.eye(K)[labels], jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((NF + 1) * K), jnp.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)

    def obj_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_loss(x, Xb, Yb, None, 1e-1)

    variants = {
        "oLBFGS": FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=10),
                               grad_fn, donate=True),
        "oLBFGS (interleaved)": FusedTrainer(
            "oLBFGS", OLBFGSConfig.create(mem_size=10,
                                          pairs_interleaved=True),
            grad_fn, donate=True),
        "oLBFGS (bf16 pairs)": FusedTrainer(
            "oLBFGS", OLBFGSConfig.create(mem_size=10, pairs_bf16=True),
            grad_fn, donate=True),
        "oLBFGS (bf16+interleaved)": FusedTrainer(
            "oLBFGS", OLBFGSConfig.create(mem_size=10, pairs_bf16=True,
                                          pairs_interleaved=True),
            grad_fn, donate=True),
        "SQN (jvp hess-vec)": FusedTrainer(
            "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=L), grad_fn, donate=True),
        "SQN (grad-diff)": FusedTrainer(
            "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=L,
                                    use_grad_diff=True), grad_fn, donate=True),
        "SQN (bf16 pairs)": FusedTrainer(
            "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=L,
                                    pairs_bf16=True), grad_fn, donate=True),
        "adaQN (fisher)": FusedTrainer(
            "adaQN", AdaQNConfig.create(mem_size=10, fisher_size=100,
                                        bfgs_upd_freq=L,
                                        rmsprop_weight=0.9), grad_fn,
            obj_fn=obj_fn, donate=True),
        "adaQN (fisher bf16)": FusedTrainer(
            "adaQN", AdaQNConfig.create(mem_size=10, fisher_size=100,
                                        bfgs_upd_freq=L, rmsprop_weight=0.9,
                                        fisher_bf16=True), grad_fn,
            obj_fn=obj_fn, donate=True),
        "adaQN (fisher_size=4)": FusedTrainer(
            "adaQN", AdaQNConfig.create(mem_size=10, fisher_size=4,
                                        bfgs_upd_freq=L,
                                        rmsprop_weight=0.9), grad_fn,
            obj_fn=obj_fn, donate=True),
    }
    for name, tr in variants.items():
        state = tr.init(x0)
        ep = tr.jit_epoch()
        eta = jnp.float32(1e-2 if "adaQN" not in name else 1e-1)
        # two warmup epochs, then the MEDIAN of repeated multi-epoch
        # timings
        for _ in range(2):
            state, _ = ep(state, (X, Y), eta, aligned=True)
        jax.block_until_ready(state)
        reps = []
        # 20-epoch reps amortize the fixed per-rep host cost
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(20):
                state, _ = ep(state, (X, Y), eta, aligned=True)
            jax.block_until_ready(state)
            reps.append((time.perf_counter() - t0) / 20)
        dt = statistics.median(reps)
        ok = bool(jnp.all(jnp.isfinite(state.x)))
        print(f"{name:26s} {B/dt:9.0f} iters/s  ({dt*1e3:6.2f} ms/epoch, "
              f"median of {len(reps)})"
              f"{'' if ok else '  NON-FINITE!'}")


if __name__ == "__main__":
    main()
