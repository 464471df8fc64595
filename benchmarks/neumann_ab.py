"""A/B: Horner-chain vs log-depth Neumann factorization for the
commit-time triangular inversions (`ops/pairs._small_cache`).

The cache's (I + N)^{-1} pair used to be the m-1-step Horner chain
(X <- I - N X, 9 dependent [2, m, m] matmuls at m=10); the log-depth
form (I - N)(I + N^2)(I + N^4)... cuts the dependent-matmul critical
path to 4 (6 ops total, squarings overlapping the product chain).
oLBFGS rebuilds the cache EVERY iteration (`commit_pair` without
``direction_cache``), so the inversion chain is most of its small-math
cost.

Both variants are traced in ONE process: `pairs._small_cache` is
monkey-patched to the Horner-bodied variant before tracing engine A and
restored to the HEAD (log-depth) body before engine B — compiled
executables freeze whatever was traced — then timed with interleaved
reps.  On the A side the log-depth inverses are computed-then-
overwritten, which XLA dead-code-eliminates, so each side pays exactly
its own chain.  Not yet run on the H100.

Workload: production oLBFGS, flagship shape, bf16+interleaved pairs
(unroll auto=8).
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
from stochqn_tpu.ops.two_loop import PRECISION

N_FEATURES, N_CLASSES = 1836, 159
BATCH_SIZE, NUM_BATCHES = 50, 120
MEM_SIZE = 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32
EPOCHS_PER_REP, N_REPS = 20, 5

_logdepth_small_cache = pairs_mod._small_cache


def _horner_small_cache(gram, head, count, mem_size, direction_cache=False,
                        interleaved=False, shift=False):
    """HEAD's cache with the inversions swapped back to the pre-round-5
    Horner chain.  The log-depth inverses inside the wrapped call are
    overwritten (hence DCE'd); everything else is byte-identical."""
    out = _logdepth_small_cache(gram, head, count, mem_size,
                                direction_cache=direction_cache,
                                interleaved=interleaved, shift=shift)
    m = mem_size
    acc_t = gram.dtype
    perm, rho = out["perm"], out["rho"]
    if interleaved:
        sy = gram[0::2, 1::2][perm][:, perm]
    else:
        sy = gram[:m, m:][perm][:, perm]
    eye = jnp.eye(m, dtype=acc_t)
    ru = jnp.triu(rho[:, None] * sy, k=1)
    rl = jnp.tril(rho[:, None] * sy.T, k=-1)
    n_stack = jnp.stack([ru, rl])
    inv = jnp.broadcast_to(eye, (2, m, m))
    for _ in range(m - 1):
        inv = eye - jnp.matmul(n_stack, inv,
                               preferred_element_type=acc_t,
                               precision=PRECISION)
    out["bwd_inv"], out["fwd_inv"] = inv[0], inv[1]
    assert not direction_cache, "A/B covers the oLBFGS (no-c0/cg) cache"
    return out


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

    cfg = OLBFGSConfig.create(mem_size=MEM_SIZE, pairs_interleaved=True,
                              pairs_bf16=True)
    trainer = FusedTrainer("oLBFGS", cfg, grad_fn)
    return trainer, x0, (X, Y)


def _run_epochs(trainer, state, data, step):
    def body(st, _):
        st, infos = trainer.epoch(st, data, step)
        return st, infos[-1]
    return jax.lax.scan(body, state, None, length=EPOCHS_PER_REP)


def main():
    trainer, x0, data = build()
    steps = EPOCHS_PER_REP * NUM_BATCHES
    fns, states = {}, {}
    for name, cache_fn in [("horner", _horner_small_cache),
                           ("logdepth", _logdepth_small_cache)]:
        pairs_mod._small_cache = cache_fn
        fns[name] = jax.jit(
            lambda st, d, s, _t=trainer: _run_epochs(_t, st, d, s))
        states[name] = trainer.init(x0)
        st, _ = fns[name](states[name], data, STEP)   # trace + warm here
        float(st.x[0])
        states[name] = st
    pairs_mod._small_cache = _logdepth_small_cache

    times = {"horner": [], "logdepth": []}
    for rep in range(N_REPS):
        order = (("horner", "logdepth") if rep % 2 == 0
                 else ("logdepth", "horner"))
        for name in order:
            t0 = time.perf_counter()
            st, _ = fns[name](states[name], data, STEP)
            float(st.x[0])                             # scalar D2H barrier
            times[name].append(time.perf_counter() - t0)
            states[name] = st

    us = {k: [1e6 * t / steps for t in v] for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    pairs = list(zip(us["logdepth"], us["horner"]))
    print(json.dumps({
        "metric": "olbfgs_neumann_ab_us_per_step",
        "horner_us_per_step_median": round(med["horner"], 2),
        "logdepth_us_per_step_median": round(med["logdepth"], 2),
        "ratio_logdepth_over_horner": round(med["logdepth"] / med["horner"],
                                            4),
        "pairs_logdepth_faster": sum(1 for a, b in pairs if a < b),
        "n_pairs": len(pairs),
        "reps_us": {k: [round(x, 2) for x in v] for k, v in us.items()},
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
