"""oLBFGS paired-gradient pipelining vs the sequential two-gradient step.

Measures the flagship BibTeX-shaped workload (see all_optimizers.py) with
``FusedTrainer(paired_grads=...)`` toggled.  The paired layout fuses the two
per-iteration gradient evaluations (``src/stochqn.c:991-1031``) into one
vmapped call.  Not yet run on the H100.
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

from stochqn_tpu.core.config import OLBFGSConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

NF, K, BS, B = 1836, 159, 50, 120


def main():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((B, BS, NF)), jnp.float32)
    labels = rng.integers(0, K, (B, BS))
    Y = jnp.asarray(np.eye(K)[labels], jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((NF + 1) * K), jnp.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)

    results = {}
    for paired in (False, True):
        tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=10),
                          grad_fn, paired_grads=paired)
        state = tr.init(x0)
        ep = jax.jit(tr.epoch, static_argnames=("aligned",))
        for _ in range(2):
            state, _ = ep(state, (X, Y), jnp.float32(1e-2))
        float(jnp.sum(state.x))  # D2H barrier
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(5):
                state, _ = ep(state, (X, Y), jnp.float32(1e-2))
            float(jnp.sum(state.x))
            reps.append((time.perf_counter() - t0) / 5)
        dt = statistics.median(reps)
        ok = bool(jnp.all(jnp.isfinite(state.x)))
        results[paired] = B / dt
        print(f"paired={paired!s:5s} {B/dt:9.0f} iters/s "
              f"({dt*1e3:6.2f} ms/epoch, median of {len(reps)}, "
              f"reps {min(reps)*1e3:.2f}-{max(reps)*1e3:.2f} ms)"
              f"{'' if ok else '  NON-FINITE!'}")
    print(f"speedup: {results[True]/results[False]:.3f}x")


if __name__ == "__main__":
    main()
