"""A/B: SQN boundary Hessian-vector via jvp-of-grad vs the closed-form
multinomial hessvec (``FusedTrainer.hess_vec_fn``), flagship shape.

The jvp builds the product from the gradient's linearization (~4 big
matmuls: primal logits + tangent logits + primal backward + tangent
backward); the analytic Gauss/true multinomial hessvec is 3 (logits, zv,
and the single backward contraction) plus cheap softmax arithmetic.  The
boundary runs once per ``upd_freq=20`` steps on the 1000-row big batch,
so the win is bounded by the boundary's share of a step.  Not yet run on
the H100.

Method: 20-epoch single-dispatch reps (2,400 steps each), reps of the two
engines interleaved in time, scalar device-to-host read as the timing
barrier.  Prints one JSON line.
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

N_FEATURES, N_CLASSES = 1836, 159
BATCH_SIZE, NUM_BATCHES = 50, 120
UPD_FREQ, MEM_SIZE = 20, 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32
EPOCHS_PER_REP, N_REPS = 20, 5


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

    def hess_vec_fn(x, v, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_hessvec(x, v, Xb, Yb, None, REG)

    cfg = SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ)
    tr_jvp = FusedTrainer("SQN", cfg, grad_fn)
    tr_hv = FusedTrainer("SQN", cfg, grad_fn, hess_vec_fn=hess_vec_fn)
    return tr_jvp, tr_hv, x0, (X, Y)


def main():
    tr_jvp, tr_hv, x0, data = build()
    steps = EPOCHS_PER_REP * NUM_BATCHES
    fns, states = {}, {}
    for name, tr in [("jvp", tr_jvp), ("analytic", tr_hv)]:
        fns[name] = tr.jit_epochs()
        states[name] = tr.init(x0)
    # warm both compiles before any timing
    for name in fns:
        st, _ = fns[name](states[name], data, STEP, EPOCHS_PER_REP)
        float(st.x[0])
        states[name] = st

    times = {"jvp": [], "analytic": []}
    for rep in range(N_REPS):
        for name in ("jvp", "analytic") if rep % 2 == 0 else (
                "analytic", "jvp"):
            t0 = time.perf_counter()
            st, _ = fns[name](states[name], data, STEP, EPOCHS_PER_REP)
            float(st.x[0])            # scalar D2H barrier
            times[name].append(time.perf_counter() - t0)
            states[name] = st

    us = {k: [1e6 * t / steps for t in v] for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    pairs = list(zip(us["analytic"], us["jvp"]))
    out = {
        "metric": "sqn_hessvec_ab_us_per_step",
        "jvp_us_per_step": {k: round(v, 2) for k, v in
                            zip(("median",), (med["jvp"],))},
        "analytic_us_per_step": round(med["analytic"], 2),
        "jvp_us_per_step_median": round(med["jvp"], 2),
        "ratio_analytic_over_jvp": round(med["analytic"] / med["jvp"], 4),
        "pairs_analytic_faster": sum(1 for a, b in pairs if a < b),
        "n_pairs": len(pairs),
        "reps_us": {k: [round(x, 2) for x in v] for k, v in us.items()},
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
