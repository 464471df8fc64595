"""Attribute adaQN's per-step budget op by op.

This sweep times ABLATED variants of the base step (semantics-breaking,
benchmark-only) to pin adaQN's cost over SQN's to specific ops:

  full       — the production `_adaqn_base`
  no_append  — Fisher ring append removed
  no_rms     — RMSProp accumulator frozen (constant diag)
  no_couple  — diagonal-H0 coupling replaced by the gamma-scalar coupling
               (SQN-shaped two-loop on the same memory)
  sqn        — `_sqn_base` reference on the identical problem

Chained-state timing, marginal differencing between two chain lengths.
Not yet run on the H100.
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import AdaQNConfig, SQNConfig
from stochqn_tpu.fused import FusedTrainer, _adaqn_base, _sqn_base
from stochqn_tpu.models import losses
from stochqn_tpu.ops.accumulators import diag_rescal
from stochqn_tpu.ops.pairs import conditional_flush, direction_is_bad
from stochqn_tpu.ops.two_loop import two_loop_cached

N_FEATURES, N_CLASSES, BS, MEM, L, FISHER = 1836, 159, 50, 10, 20, 4
N = (N_FEATURES + 1) * N_CLASSES
B = 2 * L


def grad_fn(x, batch):
    X, Y = batch
    return losses.multinomial_logistic_grad(x, X, Y, None, 1e-1)


def obj_fn(x, batch):
    X, Y = batch
    return losses.multinomial_logistic_loss(x, X, Y, None, 1e-1)


def base_variant(cfg, variant):
    """An `_adaqn_base`-shaped step with one op ablated.

    ``defer`` = no ring write, but the gradient is emitted as a scan
    OUTPUT (the deferred-append round layout's actual shape).
    """

    def step(state, batch, step_size):
        g = grad_fn(state.x, batch)
        fisher = state.fisher
        if variant not in ("no_append", "defer"):
            fisher = fisher.append(g)
        if variant == "no_rms":
            acc_sq = state.grad_sum_sq
            h0_diag = jnp.full_like(g, 0.5)
            rescaled = g * 0.5
        else:
            rescaled, acc_sq = diag_rescal(g, state.grad_sum_sq,
                                           cfg.scal_reg, cfg.rmsprop_weight)
            h0_diag = jax.lax.rsqrt(
                acc_sq + jnp.asarray(cfg.scal_reg, acc_sq.dtype))
        if variant == "no_couple":
            d_mem = two_loop_cached(g, state.mem)
        else:
            d_mem = two_loop_cached(g, state.mem, diag=h0_diag)
        d = jnp.where(state.mem.count > 0, d_mem, rescaled)
        bad = direction_is_bad(d)
        x_new = jnp.where(bad, state.x, state.x - step_size * d)
        mem = conditional_flush(state.mem, bad)
        out = g if variant == "defer" else bad
        return state.replace(x=x_new, mem=mem, fisher=fisher,
                             grad_sum_sq=acc_sq, niter=state.niter + 1,
                             x_sum=state.x_sum + x_new), out

    return step


def main():
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Yb = jnp.asarray(np.eye(N_CLASSES)[rng.integers(0, N_CLASSES, (B, BS))],
                     jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N), jnp.float32)

    acfg = AdaQNConfig.create(mem_size=MEM, fisher_size=FISHER,
                              bfgs_upd_freq=L, max_incr=1.01,
                              rmsprop_weight=0.9)
    atr = FusedTrainer("adaQN", acfg, grad_fn, obj_fn=obj_fn, donate=True)
    # a warmed state so the two-loop direction path is live
    warm, _ = atr.jit_epoch()(atr.init(x0), (X, Yb), jnp.float32(1e-2),
                              aligned=True)

    def timed(step_fn, state):
        # The whole chain lives inside ONE jit (a per-step dispatch would
        # pay the host's fixed cost per call); marginal cost from
        # differencing two chain lengths.  The chains are nested scans of
        # 2 vs 10 sweeps over the 40 batches (a 320-step signal), so the
        # difference clears the per-dispatch noise.
        def chain(state, data, sweeps):
            def sweep(st, _):
                def body(st2, batch):
                    st2, out = step_fn(st2, batch, jnp.float32(1e-2))
                    return st2, out
                st, outs = jax.lax.scan(body, st, data)
                # keep per-step outputs alive without stacking them
                # across sweeps: fold the last one into the carry
                probe = jax.tree_util.tree_leaves(outs)[0]
                # 1e-30 (not 0.0): multiply-by-zero could be simplified
                # away and the probe DCE'd; 1e-30 * sum underflows at
                # runtime but is opaque to the compiler
                st = st.replace(
                    x=st.x + 1e-30 * jnp.sum(probe).astype(st.x.dtype))
                return st, ()
            return jax.lax.scan(sweep, state, None, length=sweeps)[0]

        cj = jax.jit(chain, static_argnames=("sweeps",))
        s = cj(state, (X, Yb), sweeps=2)
        s = cj(s, (X, Yb), sweeps=10)
        float(jnp.sum(s.x))
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            s = cj(s, (X, Yb), sweeps=2)
            float(jnp.sum(s.x))
            t1 = time.perf_counter()
            s = cj(s, (X, Yb), sweeps=10)
            float(jnp.sum(s.x))
            t2 = time.perf_counter()
            reps.append(((t2 - t1) - (t1 - t0)) / (8 * B))
        return sorted(reps)[2] * 1e6

    results = {}
    for variant in ("full", "no_append", "defer", "no_rms", "no_couple"):
        results[variant] = timed(base_variant(acfg, variant), warm)
        print(f"{variant:10s}: {results[variant]:7.1f} us/step", flush=True)

    scfg = SQNConfig.create(mem_size=MEM, bfgs_upd_freq=L)
    stro = FusedTrainer("SQN", scfg, grad_fn, donate=True)
    swarm, _ = stro.jit_epoch()(stro.init(x0), (X, Yb), jnp.float32(1e-2),
                                aligned=True)
    results["sqn"] = timed(functools.partial(_sqn_base, scfg, grad_fn),
                           swarm)
    print(f"{'sqn':10s}: {results['sqn']:7.1f} us/step", flush=True)


if __name__ == "__main__":
    main()
