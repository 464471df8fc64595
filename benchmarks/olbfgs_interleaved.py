"""oLBFGS pair-layout A/B: block [m, n]x2 vs the interleaved layout.

The interleaved layout turns oLBFGS's every-iteration ring commit into ONE
contiguous [2, n] write instead of two [n] row writes, and the Gram
row/column refresh into two contiguous slab writes instead of four
(``core.state.BFGSMemoryInterleaved``).  This script measures whether the
layout collects the write it saves.  Not yet run on the H100.

Methodology: long-chain differencing (>=320-step signal) with the two
layouts' repetitions INTERLEAVED in time (rep k of both adjacent).  One
process per card.
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

from stochqn_tpu.core.config import OLBFGSConfig
from stochqn_tpu.fused import FusedTrainer, olbfgs_step
from stochqn_tpu.models import losses

N_FEATURES, N_CLASSES, BS, MEM = 1836, 159, 50, 10
N = (N_FEATURES + 1) * N_CLASSES
B = 40


def grad_fn(x, batch):
    X, Y = batch
    return losses.multinomial_logistic_grad(x, X, Y, None, 1e-1)


def make_chain(cfg):
    def chain(state, data, sweeps):
        def sweep(st, _):
            def body(st2, batch):
                return olbfgs_step(cfg, grad_fn, st2, batch,
                                   jnp.float32(1e-2))
            st, infos = jax.lax.scan(body, st, data)
            return st.replace(
                x=st.x + 1e-30 * jnp.sum(infos).astype(st.x.dtype)), ()
        return jax.lax.scan(sweep, state, None, length=sweeps)[0]
    return jax.jit(chain, static_argnames=("sweeps",))


def main():
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Y = jnp.asarray(np.eye(N_CLASSES)[rng.integers(0, N_CLASSES, (B, BS))],
                    jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N), jnp.float32)

    runs = {}
    for name, interleaved in (("block", False), ("interleaved", True)):
        cfg = OLBFGSConfig.create(mem_size=MEM, min_curvature=None,
                                  pairs_interleaved=interleaved)
        tr = FusedTrainer("oLBFGS", cfg, grad_fn, donate=True)
        warm, _ = tr.jit_epoch()(tr.init(x0), (X, Y), jnp.float32(1e-2))
        cj = make_chain(cfg)
        s = cj(warm, (X, Y), sweeps=2)
        s = cj(s, (X, Y), sweeps=10)
        float(jnp.sum(s.x))
        runs[name] = (cj, s)

    reps = {"block": [], "interleaved": []}
    for rep in range(7):
        for name in ("block", "interleaved"):   # interleave reps in time
            cj, s = runs[name]
            t0 = time.perf_counter()
            s = cj(s, (X, Y), sweeps=2)
            float(jnp.sum(s.x))
            t1 = time.perf_counter()
            s = cj(s, (X, Y), sweeps=10)
            float(jnp.sum(s.x))
            t2 = time.perf_counter()
            runs[name] = (cj, s)
            reps[name].append(((t2 - t1) - (t1 - t0)) / (8 * B) * 1e6)

    out = {}
    for name, vals in reps.items():
        vals = sorted(vals)
        med = vals[len(vals) // 2]
        out[name] = med
        print(f"{name:12s}: {med:7.1f} us/step "
              f"(min {vals[0]:.1f}, max {vals[-1]:.1f})", flush=True)
    speedup = out["block"] / out["interleaved"]
    print(f"interleaved speedup: {speedup:.3f}x "
          f"({out['block'] - out['interleaved']:+.1f} us/step)")


if __name__ == "__main__":
    main()
