"""SQN flagship pair-layout A/B (block vs interleaved flat [2m, n]).

SQN commits only at upd_freq boundaries, so the interleaved layout's
ring-write saving amortizes away — but its projection/expansion use the
[2m, n] buffer DIRECTLY where the block layout feeds concat([s, y]) to
the matmuls.  This measures the difference on the bench.py workload
(interleaved reps, 20-epoch chains).  Not yet run on the H100.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

N_FEATURES, N_CLASSES, BS, MEM, L, B = 1836, 159, 50, 10, 20, 120
EPOCHS_PER_REP = 10


def main():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Y = jnp.asarray(np.eye(N_CLASSES)[rng.integers(0, N_CLASSES, (B, BS))],
                    jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES),
                     jnp.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)

    runs = {}
    for name, interleaved in (("block", False), ("interleaved", True)):
        cfg = SQNConfig.create(mem_size=MEM, bfgs_upd_freq=L,
                               pairs_interleaved=interleaved)
        tr = FusedTrainer("SQN", cfg, grad_fn, donate=True)
        st = tr.init(x0)
        ep = tr.jit_epoch()
        for _ in range(2):
            st, _ = ep(st, (X, Y), jnp.float32(1e-2), aligned=True)
        float(jnp.sum(st.x))
        runs[name] = (ep, st, (X, Y))

    reps = {"block": [], "interleaved": []}
    for rep in range(7):
        for name in ("block", "interleaved"):
            ep, st, data = runs[name]
            t0 = time.perf_counter()
            for _ in range(EPOCHS_PER_REP):
                st, _ = ep(st, data, jnp.float32(1e-2), aligned=True)
            float(jnp.sum(st.x))
            dt = time.perf_counter() - t0
            runs[name] = (ep, st, data)
            reps[name].append(EPOCHS_PER_REP * B / dt)

    for name, vals in reps.items():
        vals = sorted(vals)
        print(f"{name:12s}: {vals[len(vals) // 2]:8.0f} iters/s "
              f"(min {vals[0]:.0f}, max {vals[-1]:.0f})", flush=True)
    print(f"ratio: {sorted(reps['interleaved'])[3] / sorted(reps['block'])[3]:.3f}")


if __name__ == "__main__":
    main()
