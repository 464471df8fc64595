"""Does XLA hoist the pair memory out of the scan when it threads through a
scan CARRY (the fused engine's layout), or only when it is loop-invariant?

The production inner scan threads ``mem.s/mem.y`` through the carry
unchanged within a round — this measures the collapsed direction both
ways, deciding whether FusedTrainer.round should rebind the pair arrays
as closure invariants.  Not yet run on the H100.

Run alone (one process per card):  python benchmarks/carry_vs_invariant.py
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

M = 10
PREC = jax.lax.Precision.HIGHEST


def direction(g, s, y, c, gamma):
    w = jnp.concatenate([s, y], axis=0)
    wg = jnp.matmul(w, g, precision=PREC, preferred_element_type=jnp.float32)
    u = jnp.matmul(c, wg, precision=PREC)
    return gamma * g + jnp.matmul(u, w, precision=PREC,
                                  preferred_element_type=jnp.float32)


def measure(n, iters, mode):
    rng = np.random.default_rng(0)
    s = jnp.asarray(rng.standard_normal((M, n)), jnp.float32)
    y = s + 0.3 * jnp.asarray(rng.standard_normal((M, n)), jnp.float32)
    c = jnp.asarray(rng.standard_normal((2 * M, 2 * M)) * 0.01, jnp.float32)
    g0 = jnp.asarray(rng.standard_normal(n), jnp.float32)
    gamma = jnp.float32(0.7)

    @functools.partial(jax.jit, static_argnames=("length",))
    def chain(g, g0, s, y, c, length):
        if mode == "carry":
            def body(carry, t):
                g, acc, s_c, y_c = carry
                d = direction(g, s_c, y_c, c, gamma)
                g2 = g0 + 1e-5 * d + t * 1e-8
                # s_c, y_c pass through UNCHANGED — like mem in the round
                return (g2, acc + jnp.sum(g2[:8]), s_c, y_c), None
            (g, acc, _, _), _ = jax.lax.scan(
                body, (g, jnp.float32(0), s, y),
                jnp.arange(length, dtype=jnp.float32))
        else:  # invariant
            def body(carry, t):
                g, acc = carry
                d = direction(g, s, y, c, gamma)
                g2 = g0 + 1e-5 * d + t * 1e-8
                return (g2, acc + jnp.sum(g2[:8])), None
            (g, acc), _ = jax.lax.scan(
                body, (g, jnp.float32(0)),
                jnp.arange(length, dtype=jnp.float32))
        return g + acc * 1e-12, acc

    g, a = chain(g0, g0, s, y, c, iters)
    float(a)
    g, a = chain(g, g0, s, y, c, 4 * iters)
    float(a)

    def run(length, g):
        best = float("inf")
        for rep in range(3):
            g = g + jnp.float32(1e-7 * (rep + 1))
            t0 = time.perf_counter()
            g, acc = chain(g, g0, s, y, c, length)
            float(acc)                      # D2H completion barrier
            best = min(best, time.perf_counter() - t0)
        return best, g

    t_short, g = run(iters, g)
    t_long, g = run(4 * iters, g)
    return max(t_long - t_short, 1e-9) / (3 * iters) * 1e6


if __name__ == "__main__":
    from stochqn_tpu.utils import compile_cache
    compile_cache.enable()
    for n in (292_083, 1_000_000):
        for mode in ("invariant", "carry"):
            us = measure(n, 1000, mode)
            print(f"n={n:>9,} {mode:9s}: {us:7.1f} us/step")
