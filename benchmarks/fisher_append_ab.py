"""A/B: adaQN's per-step Fisher append as a dynamic-update-slice ring
write vs a SHIFT rewrite (`concat([g, f[:-1]])`).

The append is adaQN's structural per-step cost over SQN.  Fisher rows
are consumed only through the symmetric product ``F^T (F s) / count`` so
chronological order is irrelevant — a newest-first shift buffer computes
identical math.  A rewrite can beat a DUS into a scan carry when the
buffer is small (one fused pass, no carry copy); for fs=100 the
rewrite's full-buffer traffic (2 x fs x n bytes/step) should lose.  This
harness measures both at a given ``--fs`` with both variants traced in
one process (monkey-patched ``FisherMemory.append``) and interleaved
reps.  Not yet run on the H100.

Workload: production adaQN, flagship shape, reference defaults except
``fisher_size``.
"""
import argparse
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

from stochqn_tpu.core.config import AdaQNConfig
from stochqn_tpu.core.state import FisherMemory
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses

N_FEATURES, N_CLASSES = 1836, 159
BATCH_SIZE, NUM_BATCHES = 50, 120
UPD_FREQ, MEM_SIZE = 20, 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32
EPOCHS_PER_REP, N_REPS = 20, 5

_dus_append = FisherMemory.append


def _shift_append(self, grad):
    size = self.f.shape[0]
    f = jnp.concatenate([grad.astype(self.f.dtype)[None], self.f[:-1]],
                        axis=0)
    return self.replace(
        f=f,
        head=(self.head + 1) % size,   # head kept for protocol parity
        count=jnp.minimum(self.count + 1, size),
    )


def build(fs):
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal(
        (NUM_BATCHES, BATCH_SIZE, N_FEATURES)), DTYPE)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], DTYPE)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES), DTYPE)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, REG)

    def obj_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_loss(x, Xb, Yb, None, REG)

    cfg = AdaQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ,
                             fisher_size=fs, max_incr=1.01)
    return FusedTrainer("adaQN", cfg, grad_fn, obj_fn=obj_fn), x0, (X, Y)


def _run_epochs(trainer, state, data, step):
    def body(st, _):
        st, infos = trainer.epoch(st, data, step)
        return st, infos[-1]
    return jax.lax.scan(body, state, None, length=EPOCHS_PER_REP)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs", type=int, default=4)
    args = ap.parse_args()
    trainer, x0, data = build(args.fs)
    steps = EPOCHS_PER_REP * NUM_BATCHES
    fns, states = {}, {}
    for name, fn_append in [("dus", _dus_append), ("shift", _shift_append)]:
        FisherMemory.append = fn_append
        fns[name] = jax.jit(
            lambda st, d, s, _t=trainer: _run_epochs(_t, st, d, s))
        states[name] = trainer.init(x0)
        st, _ = fns[name](states[name], data, STEP)   # trace + warm
        float(st.x[0])
        states[name] = st
    FisherMemory.append = _dus_append

    times = {"dus": [], "shift": []}
    for rep in range(N_REPS):
        order = (("dus", "shift") if rep % 2 == 0 else ("shift", "dus"))
        for name in order:
            t0 = time.perf_counter()
            st, _ = fns[name](states[name], data, STEP)
            float(st.x[0])
            times[name].append(time.perf_counter() - t0)
            states[name] = st

    us = {k: [1e6 * t / steps for t in v] for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    pairs = list(zip(us["shift"], us["dus"]))
    print(json.dumps({
        "metric": "adaqn_fisher_append_ab_us_per_step",
        "fisher_size": args.fs,
        "dus_us_per_step_median": round(med["dus"], 2),
        "shift_us_per_step_median": round(med["shift"], 2),
        "ratio_shift_over_dus": round(med["shift"] / med["dus"], 4),
        "pairs_shift_faster": sum(1 for a, b in pairs if a < b),
        "n_pairs": len(pairs),
        "reps_us": {k: [round(x, 2) for x in v] for k, v in us.items()},
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
