"""Large-n showcase: SQN step cost at 16M+ parameters, f32 vs bf16 pairs.

Usage: python benchmarks/large_n.py [N] [--sqn-only|--adaqn-only]
       [--f32-only|--bf16-only]    (N defaults to 16,000,000)

At BibTeX scale (n=292k) the per-step cost sits at the backend's scan-step
floor; at production scale (n in the tens of millions) the two streaming
passes over the [2m, n] pair memory dominate and the bf16 storage option
pays off.  Chained-state timing (every epoch's input depends on the
previous output — the only trustworthy methodology on this machine).
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

N = 16_000_000
for _a in sys.argv[1:]:
    if _a.isdigit():          # e.g. `python benchmarks/large_n.py 64000000`
        N = int(_a)
B, L = 40, 8
MEM = 10


def main():
    rng = np.random.default_rng(0)
    # synthetic separable quadratic: diagonal curvature ramp + per-batch
    # target.  The curvature is synthesized from iota INSIDE the gradient —
    # a closed-over [n] constant would be embedded in the compiled program
    # (256 MB at n=64M) and cost an extra HBM stream.
    targets = jnp.asarray(rng.standard_normal((B, 1)), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N) * 0.1, jnp.float32)

    def grad_fn(x, batch):
        # cheap synthetic gradient: diag * (x - t); one pass over n
        diag = 0.5 + 1.5 * (jax.lax.iota(jnp.float32, N) / N)
        t = jnp.mean(batch)
        return diag * (x - t)

    variants = (False, True)
    if "--bf16-only" in sys.argv:
        variants = (True,)
    elif "--f32-only" in sys.argv:
        variants = (False,)
    # --interleaved: flat [2m, n] pair layout.  Besides the oLBFGS write
    # saving, at the capacity ceiling it removes the block
    # layout's concatenate([s, y]) operand, a second full-size pair-memory
    # buffer XLA materializes in the commit/projection programs.
    interleaved = "--interleaved" in sys.argv
    for bf16 in variants:
        cfg = SQNConfig.create(mem_size=MEM, bfgs_upd_freq=L,
                               use_grad_diff=True, pairs_bf16=bf16,
                               pairs_interleaved=interleaved)
        tr = FusedTrainer("SQN", cfg, grad_fn, donate=True)
        state = tr.init(x0)
        # donated state carry: without it the epoch dispatch holds
        # input+output copies of the [2m, n] pair memory
        ep = tr.jit_epoch()
        state, _ = ep(state, targets, jnp.float32(1e-2), aligned=True)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = ep(state, targets, jnp.float32(1e-2), aligned=True)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / 3
        pair_mb = 2 * MEM * N * (2 if bf16 else 4) / 1e6
        print(f"pairs_{'bf16' if bf16 else 'f32 '}: "
              f"{dt / B * 1e6:8.1f} us/iter  "
              f"({B / dt:6.0f} iters/s; pair memory {pair_mb:.0f} MB)")


def main_adaqn():
    """adaQN at 16M params: exercises the per-step diagonal-H0 projection
    and bf16 Fisher storage.  Fisher memory kept small (the [k, n] buffer
    is k * 64 MB at f32)."""
    from stochqn_tpu.core.config import AdaQNConfig

    rng = np.random.default_rng(0)
    targets = jnp.asarray(rng.standard_normal((B, 1)), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N) * 0.1, jnp.float32)

    def grad_fn(x, batch):
        diag = 0.5 + 1.5 * (jax.lax.iota(jnp.float32, N) / N)
        t = jnp.mean(batch)
        return diag * (x - t)

    # f32 storage, then full bf16 storage (pairs and Fisher)
    for bf16 in (False, True):
        cfg = AdaQNConfig.create(
            mem_size=MEM, bfgs_upd_freq=L, fisher_size=8, max_incr=None,
            pairs_bf16=bf16, fisher_bf16=bf16)
        tr = FusedTrainer("adaQN", cfg, grad_fn, donate=True)
        state = tr.init(x0)
        ep = tr.jit_epoch()
        state, _ = ep(state, targets, jnp.float32(1e-2), aligned=True)
        float(jnp.sum(state.x))
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = ep(state, targets, jnp.float32(1e-2), aligned=True)
        float(jnp.sum(state.x))
        dt = (time.perf_counter() - t0) / 3
        tag = f"adaqn pairs_{'bf16' if bf16 else 'f32 '}"
        print(f"{tag}: {dt / B * 1e6:8.1f} us/iter  ({B / dt:6.0f} iters/s)")


def main_olbfgs():
    """oLBFGS at large n: the every-iteration commit regime, where the
    interleaved [2m, n] layout's single-slab ring write and concat-free
    projection matter most.  Block vs interleaved, f32 and bf16."""
    from stochqn_tpu.core.config import OLBFGSConfig

    rng = np.random.default_rng(0)
    targets = jnp.asarray(rng.standard_normal((B, 1)), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N) * 0.1, jnp.float32)

    def grad_fn(x, batch):
        diag = 0.5 + 1.5 * (jax.lax.iota(jnp.float32, N) / N)
        t = jnp.mean(batch)
        return diag * (x - t)

    for bf16 in (False, True):
        for interleaved in (False, True):
            cfg = OLBFGSConfig.create(mem_size=MEM, min_curvature=None,
                                      pairs_bf16=bf16,
                                      pairs_interleaved=interleaved)
            tr = FusedTrainer("oLBFGS", cfg, grad_fn, donate=True)
            state = tr.init(x0)
            ep = tr.jit_epoch()
            state, _ = ep(state, targets, jnp.float32(1e-2))
            float(jnp.sum(state.x))
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = ep(state, targets, jnp.float32(1e-2))
            float(jnp.sum(state.x))
            dt = (time.perf_counter() - t0) / 3
            tag = (f"olbfgs pairs_{'bf16' if bf16 else 'f32 '} "
                   f"{'interleaved' if interleaved else 'block      '}")
            print(f"{tag}: {dt / B * 1e6:8.1f} us/iter  "
                  f"({B / dt:6.0f} iters/s)")


if __name__ == "__main__":
    only = [a for a in sys.argv[1:] if a.endswith("-only")]
    if "--olbfgs-only" in sys.argv:
        main_olbfgs()
    else:
        if "--adaqn-only" not in sys.argv:
            main()
        if "--sqn-only" not in sys.argv:
            main_adaqn()
