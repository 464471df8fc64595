"""Interleaved A/B: oLBFGS production step, inner-scan unroll 1 vs 8.

The auto ``unroll=8`` for oLBFGS (``FusedTrainer.unroll``) was chosen on
the earlier accelerator.  Timing the variants SEQUENTIALLY hands them
different host states; this A/B interleaves rep k of both arms adjacently
and reports per-pair ratios.  Not yet run on the H100.
"""
import functools
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
from stochqn_tpu.fused import FusedTrainer, olbfgs_step
from stochqn_tpu.models import losses

N_FEATURES, N_CLASSES, BS, MEM, B = 1836, 159, 50, 10, 40


def grad_fn(x, batch):
    X, Y = batch
    return losses.multinomial_logistic_grad(x, X, Y, None, 1e-1)


def main():
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Y = jnp.asarray(np.eye(N_CLASSES)[rng.integers(0, N_CLASSES, (B, BS))],
                    jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES),
                     jnp.float32)
    cfg = OLBFGSConfig.create(mem_size=MEM, min_curvature=None,
                              pairs_bf16=True, pairs_interleaved=True)
    tr = FusedTrainer("oLBFGS", cfg, grad_fn, donate=True)
    warm, _ = tr.jit_epoch()(tr.init(x0), (X, Y), jnp.float32(1e-2))

    step = functools.partial(olbfgs_step, cfg, grad_fn)

    def chain(unroll):
        def run(state, data, sweeps):
            def sweep(st, _):
                def body(st2, batch):
                    return step(st2, batch, jnp.float32(1e-2))
                st, outs = jax.lax.scan(body, st, data, unroll=unroll)
                probe = jax.tree_util.tree_leaves(outs)[0]
                return st.replace(
                    x=st.x + 1e-30 * jnp.sum(probe).astype(st.x.dtype)), ()
            return jax.lax.scan(sweep, state, None, length=sweeps)[0]
        return jax.jit(run, static_argnames=("sweeps",))

    arms = {1: chain(1), 8: chain(8)}
    states = {k: warm for k in arms}
    for k, cj in arms.items():   # compile + warm both sizes
        states[k] = cj(states[k], (X, Y), sweeps=2)
        states[k] = cj(states[k], (X, Y), sweeps=10)
        float(jnp.sum(states[k].x))

    pairs = []
    for rep in range(7):
        us = {}
        for k, cj in arms.items():
            t0 = time.perf_counter()
            states[k] = cj(states[k], (X, Y), sweeps=2)
            float(jnp.sum(states[k].x))
            t1 = time.perf_counter()
            states[k] = cj(states[k], (X, Y), sweeps=10)
            float(jnp.sum(states[k].x))
            t2 = time.perf_counter()
            us[k] = ((t2 - t1) - (t1 - t0)) / (8 * B) * 1e6
        pairs.append(us)
        print(f"rep {rep}: unroll1 {us[1]:7.1f}  unroll8 {us[8]:7.1f}  "
              f"ratio {us[8] / us[1]:.3f}", flush=True)

    r = sorted(p[8] / p[1] for p in pairs)
    u1 = statistics.median(p[1] for p in pairs)
    u8 = statistics.median(p[8] for p in pairs)
    print(f"medians: unroll1 {u1:.1f} us/step, unroll8 {u8:.1f}, "
          f"median ratio {r[len(r) // 2]:.3f} "
          f"(range {r[0]:.3f}-{r[-1]:.3f})")


if __name__ == "__main__":
    main()
