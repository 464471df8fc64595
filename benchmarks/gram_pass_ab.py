"""A/B: the commit's incremental-Gram pass as one ``[2m, n] @ [n, 2]``
matmul vs two ``[2m, n] @ [n]`` matvecs (``ops/pairs._gram_cols``).

The two-matvec form won on the earlier accelerator, where a 2-column
operand got a narrow memory tile; whether it matters on the H100 is not
measured yet.

Both variants are traced in one process by monkey-patching
``pairs._mem_mm`` with a wrapper that splits 2-column RHS matmuls
(before tracing engine B), interleaved reps — same harness as
``neumann_ab.py``.  Workload: flagship SQN (the boundary commit runs
every upd_freq=20 steps).
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

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses
from stochqn_tpu.ops import pairs as pairs_mod

N_FEATURES, N_CLASSES = 1836, 159
BATCH_SIZE, NUM_BATCHES = 50, 120
UPD_FREQ, MEM_SIZE = 20, 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32
EPOCHS_PER_REP, N_REPS = 20, 5

_matmul_mem_mm = pairs_mod._mem_mm


def _split_mem_mm(buf, rhs, acc_t):
    """``_mem_mm`` with 2-column RHS split into two matvecs (stacked
    small at the end); other shapes pass through."""
    if rhs.ndim == 2 and rhs.shape[1] == 2:
        c0 = _matmul_mem_mm(buf, rhs[:, 0], acc_t)
        c1 = _matmul_mem_mm(buf, rhs[:, 1], acc_t)
        return jnp.stack([c0, c1], axis=1)
    return _matmul_mem_mm(buf, rhs, acc_t)


def build():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal(
        (NUM_BATCHES, BATCH_SIZE, N_FEATURES)), DTYPE)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], DTYPE)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES), DTYPE)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, REG)

    cfg = SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ)
    return FusedTrainer("SQN", cfg, grad_fn), x0, (X, Y)


def _run_epochs(trainer, state, data, step):
    def body(st, _):
        st, infos = trainer.epoch(st, data, step)
        return st, infos[-1]
    return jax.lax.scan(body, state, None, length=EPOCHS_PER_REP)


def main():
    trainer, x0, data = build()
    steps = EPOCHS_PER_REP * NUM_BATCHES
    fns, states = {}, {}
    for name, mm in [("matmul2col", _matmul_mem_mm),
                     ("two_matvecs", _split_mem_mm)]:
        pairs_mod._mem_mm = mm
        fns[name] = jax.jit(
            lambda st, d, s, _t=trainer: _run_epochs(_t, st, d, s))
        states[name] = trainer.init(x0)
        st, _ = fns[name](states[name], data, STEP)   # trace + warm
        float(st.x[0])
        states[name] = st
    pairs_mod._mem_mm = _matmul_mem_mm

    times = {"matmul2col": [], "two_matvecs": []}
    for rep in range(N_REPS):
        order = (("matmul2col", "two_matvecs") if rep % 2 == 0
                 else ("two_matvecs", "matmul2col"))
        for name in order:
            t0 = time.perf_counter()
            st, _ = fns[name](states[name], data, STEP)
            float(st.x[0])
            times[name].append(time.perf_counter() - t0)
            states[name] = st

    us = {k: [1e6 * t / steps for t in v] for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    pairs = list(zip(us["two_matvecs"], us["matmul2col"]))
    print(json.dumps({
        "metric": "sqn_gram_pass_ab_us_per_step",
        "matmul2col_us_per_step_median": round(med["matmul2col"], 2),
        "two_matvecs_us_per_step_median": round(med["two_matvecs"], 2),
        "ratio_split_over_matmul": round(
            med["two_matvecs"] / med["matmul2col"], 4),
        "pairs_split_faster": sum(1 for a, b in pairs if a < b),
        "n_pairs": len(pairs),
        "reps_us": {k: [round(x, 2) for x in v] for k, v in us.items()},
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
