"""Sweep the fused engine's inner-scan unroll factor on the flagship bench.

Each XLA while-loop iteration of the fused engine carries fixed overhead
(loop bookkeeping + carry plumbing).  ``lax.scan(unroll=k)`` amortizes
it.  This sweep times the full flagship epoch (identical workload to
bench.py) at several unroll factors, median of N reps each.  Not yet run
on the H100.

Run alone (one process per card), e.g.:
    timeout 1200 python benchmarks/unroll_sweep.py
"""
import json
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

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

N_FEATURES = 1836
N_CLASSES = 159
BATCH_SIZE = 50
NUM_BATCHES = 120
UPD_FREQ = 20
MEM_SIZE = 10
REG = 1e-1
STEP = 1e-2
DTYPE = jnp.float32

N_REPS = 5
EPOCHS_PER_REP = 5
UNROLLS = (1, 2, 4, 5, 10)


def build(unroll):
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal(
        (NUM_BATCHES, BATCH_SIZE, N_FEATURES)), DTYPE)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], DTYPE)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES), DTYPE)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, REG)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ),
        grad_fn, unroll=unroll)
    return trainer, trainer.init(x0), (X, Y)


def time_unroll(unroll):
    trainer, state, data = build(unroll)
    epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
    eta = jnp.asarray(STEP, DTYPE)
    for _ in range(2):
        state, _ = epoch_fn(state, data, eta, aligned=True)
    float(jnp.sum(state.x))

    reps = []
    for _ in range(N_REPS):
        t0 = time.perf_counter()
        for _ in range(EPOCHS_PER_REP):
            state, _ = epoch_fn(state, data, eta, aligned=True)
        checksum = float(jnp.sum(state.x))   # D2H barrier
        dt = time.perf_counter() - t0
        if checksum != checksum:
            raise RuntimeError("NaN iterate")
        reps.append(EPOCHS_PER_REP * NUM_BATCHES / dt)
    return statistics.median(reps), reps


def main():
    out = {}
    for u in UNROLLS:
        med, reps = time_unroll(u)
        out[u] = {"iters_per_s": round(med, 1),
                  "reps": [round(r, 1) for r in reps]}
        print(f"unroll={u}: {med:.1f} iters/s  {[round(r) for r in reps]}",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
