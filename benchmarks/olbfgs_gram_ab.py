"""A/B: the commit's incremental-Gram pass on production oLBFGS —
single ``[.., n] @ [n, 2]`` matmul vs two ``[n]``-RHS matvecs — for a
chosen pair-storage configuration.

Sequential sweeps cannot settle a difference of a few per cent; this
harness traces both forms in one process by monkey-patching
``pairs._gram_cols`` and interleaves the timed reps, like
``neumann_ab.py``.  Not yet run on the H100.

Usage: ``python benchmarks/olbfgs_gram_ab.py [--f32]`` (default: the
production bf16+interleaved configuration).
"""
import json
import os
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
from stochqn_tpu.ops import pairs as pairs_mod
from stochqn_tpu.ops.two_loop import _mem_mm

N_FEATURES, N_CLASSES = 1836, 159
BATCH_SIZE, NUM_BATCHES = 50, 120
MEM_SIZE = 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32
EPOCHS_PER_REP, N_REPS = 20, 5


def _gram_matmul(buf, row_s, row_y, acc_t):
    return _mem_mm(buf, jnp.stack([row_s, row_y], axis=1), acc_t)


def _gram_split(buf, row_s, row_y, acc_t):
    return jnp.stack([_mem_mm(buf, row_s, acc_t),
                      _mem_mm(buf, row_y, acc_t)], axis=1)


def build(bf16):
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal(
        (NUM_BATCHES, BATCH_SIZE, N_FEATURES)), DTYPE)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], DTYPE)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES), DTYPE)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, REG)

    cfg = OLBFGSConfig.create(mem_size=MEM_SIZE, pairs_interleaved=True,
                              pairs_bf16=bf16)
    return FusedTrainer("oLBFGS", cfg, grad_fn), x0, (X, Y)


def _run_epochs(trainer, state, data, step):
    def body(st, _):
        st, infos = trainer.epoch(st, data, step)
        return st, infos[-1]
    return jax.lax.scan(body, state, None, length=EPOCHS_PER_REP)


def main():
    bf16 = "--f32" not in sys.argv
    trainer, x0, data = build(bf16)
    steps = EPOCHS_PER_REP * NUM_BATCHES
    orig = pairs_mod._gram_cols
    fns, states = {}, {}
    for name, gc in [("matmul2col", _gram_matmul), ("split", _gram_split)]:
        pairs_mod._gram_cols = gc
        fns[name] = jax.jit(
            lambda st, d, s, _t=trainer: _run_epochs(_t, st, d, s))
        states[name] = trainer.init(x0)
        st, _ = fns[name](states[name], data, STEP)   # trace + warm
        float(st.x[0])
        states[name] = st
    pairs_mod._gram_cols = orig

    times = {"matmul2col": [], "split": []}
    for rep in range(N_REPS):
        order = (("matmul2col", "split") if rep % 2 == 0
                 else ("split", "matmul2col"))
        for name in order:
            t0 = time.perf_counter()
            st, _ = fns[name](states[name], data, STEP)
            float(st.x[0])
            times[name].append(time.perf_counter() - t0)
            states[name] = st

    us = {k: [1e6 * t / steps for t in v] for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    pairs = list(zip(us["split"], us["matmul2col"]))
    print(json.dumps({
        "metric": "olbfgs_gram_ab_us_per_step",
        "storage": "bf16" if bf16 else "f32",
        "matmul2col_us_per_step_median": round(med["matmul2col"], 2),
        "split_us_per_step_median": round(med["split"], 2),
        "ratio_split_over_matmul": round(med["split"] / med["matmul2col"],
                                         4),
        "pairs_split_faster": sum(1 for a, b in pairs if a < b),
        "n_pairs": len(pairs),
        "reps_us": {k: [round(x, 2) for x in v] for k, v in us.items()},
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
