"""Attribute oLBFGS's per-step budget op by op.

oLBFGS's step = two same-batch gradients + a FULL pair commit every
iteration (``src/stochqn.c:978-1036``).  Ablated variants
(semantics-breaking, benchmark-only) pin the cost to specific pieces:

  full         — the production `olbfgs_step`
  one_grad     — second (same-batch) gradient removed
  no_commit    — direction + step only, memory never written
  rows_only    — ring rows written, but no incremental Gram pass and no
                 small-math cache rebuild
  no_cache     — rows + Gram pass, but no small-math cache rebuild
  sqn_base     — `_sqn_base` reference point

Long-chain differencing (>=320-step signal).  Not yet run on the H100.
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

from stochqn_tpu.core.config import OLBFGSConfig, SQNConfig
from stochqn_tpu.fused import FusedTrainer, _sqn_base, olbfgs_step
from stochqn_tpu.ops.pairs import (_small_cache, conditional_flush,
                                   direction_is_bad)
from stochqn_tpu.ops.two_loop import PRECISION, _mem_mm, two_loop_cached
from stochqn_tpu.models import losses

N_FEATURES, N_CLASSES, BS, MEM = 1836, 159, 50, 10
N = (N_FEATURES + 1) * N_CLASSES
B = 40


def grad_fn(x, batch):
    X, Y = batch
    return losses.multinomial_logistic_grad(x, X, Y, None, 1e-1)


def variant_step(cfg, variant):
    def step(state, batch, step_size):
        g = grad_fn(state.x, batch)
        d = two_loop_cached(g, state.mem, h0=cfg.hess_init)
        bad = direction_is_bad(d)
        s_cand = -step_size * d
        x_new = jnp.where(bad, state.x, state.x + s_cand)
        mem = conditional_flush(state.mem.replace(s_pending=s_cand), bad)

        if variant == "one_grad":
            y_cand = g * 1.000001 - g          # fake y, no second grad
        else:
            g2 = grad_fn(x_new, batch)
            y_cand = g2 - g

        if variant == "no_commit":
            mem_final = state.mem
        else:
            # inline commit with pieces ablated
            size = mem.mem_size
            st_t = mem.s.dtype
            row_s = s_cand.astype(st_t)
            row_y = y_cand.astype(st_t)
            new_s = jax.lax.dynamic_update_index_in_dim(
                mem.s, row_s, mem.head, axis=0)
            new_y = jax.lax.dynamic_update_index_in_dim(
                mem.y, row_y, mem.head, axis=0)
            mem_final = mem.replace(
                s=new_s, y=new_y,
                head=(mem.head + 1) % size,
                count=jnp.minimum(mem.count + 1, size))
            if variant in ("full", "no_cache"):
                gram_t = mem.gram.dtype
                w_new = jnp.concatenate([new_s, new_y], axis=0)
                p = _mem_mm(w_new, jnp.stack([row_s, row_y], axis=1),
                            gram_t)
                gram = mem.gram
                for axis in (0, 1):
                    gram = jax.lax.dynamic_update_index_in_dim(
                        gram, p[:, 0].astype(gram_t), mem.head, axis=axis)
                    gram = jax.lax.dynamic_update_index_in_dim(
                        gram, p[:, 1].astype(gram_t), size + mem.head,
                        axis=axis)
                mem_final = mem_final.replace(gram=gram)
                if variant == "full":
                    cache = _small_cache(gram, mem_final.head,
                                         mem_final.count, size)
                    mem_final = mem_final.replace(**cache)

        mem_final = mem_final.replace(s_pending=state.mem.s_pending)
        return state.replace(x=x_new, mem=mem_final,
                             niter=state.niter + 1), bad

    return step


def variant_step_interleaved(cfg, variant):
    """The bf16+interleaved ladder: same ablation
    ideas against the production flat-[2m, n] storage.  Variants:
    full / one_grad / no_commit / slab_only (the single [2, n] ring-slab
    write, no Gram, no cache) / no_cache (slab + Gram slabs)."""
    def step(state, batch, step_size):
        g = grad_fn(state.x, batch)
        d = two_loop_cached(g, state.mem, h0=cfg.hess_init)
        bad = direction_is_bad(d)
        s_cand = -step_size * d
        x_new = jnp.where(bad, state.x, state.x + s_cand)
        mem = conditional_flush(state.mem.replace(s_pending=s_cand), bad)

        if variant == "one_grad":
            y_cand = g * 1.000001 - g
        else:
            g2 = grad_fn(x_new, batch)
            y_cand = g2 - g

        if variant == "no_commit":
            mem_final = state.mem
        elif variant == "gram_old_buf":
            # shift commit whose Gram pass reads the OLD buffer (it is
            # independent of the shift write, so XLA can overlap them;
            # the new pair's own 2x2 corner comes from three dots)
            st_t = mem.sy.dtype
            slab = jnp.stack([s_cand.astype(st_t), y_cand.astype(st_t)])
            new_sy = jnp.concatenate([slab, mem.sy[:-2]], axis=0)
            gram_t = mem.gram.dtype
            q = _mem_mm(mem.sy[:-2], slab.T, gram_t)       # [2m-2, 2]
            ss = jnp.vdot(s_cand, s_cand).astype(gram_t)
            sy = jnp.vdot(s_cand, y_cand).astype(gram_t)
            yy = jnp.vdot(y_cand, y_cand).astype(gram_t)
            corner = jnp.stack([jnp.stack([ss, sy]),
                                jnp.stack([sy, yy])])
            p = jnp.concatenate([corner, q], axis=0)       # [2m, 2]
            g_shift = jnp.zeros_like(mem.gram)
            g_shift = g_shift.at[2:, 2:].set(mem.gram[:-2, :-2])
            g_shift = g_shift.at[:, 0:2].set(p)
            g_shift = g_shift.at[0:2, :].set(p.T)
            mem_final = mem.replace(
                sy=new_sy, gram=g_shift,
                count=jnp.minimum(mem.count + 1, mem.mem_size))
            cache = _small_cache(g_shift, mem_final.head, mem_final.count,
                                 mem.mem_size, interleaved=True,
                                 shift=True)
            mem_final = mem_final.replace(**cache)
            mem_final = mem_final.replace(s_pending=state.mem.s_pending)
            return state.replace(x=x_new, mem=mem_final,
                                 niter=state.niter + 1), bad
        elif variant == "slab_shift":
            # ring-as-shift: rewrite the whole [2m, n] buffer each step
            # (newest pair always rows 0-1) — trades the DUS carry-copy
            # for one full sequential rewrite.  head stays 0.
            st_t = mem.sy.dtype
            slab = jnp.stack([s_cand.astype(st_t), y_cand.astype(st_t)])
            new_sy = jnp.concatenate([slab, mem.sy[:-2]], axis=0)
            mem_final = mem.replace(
                sy=new_sy,
                count=jnp.minimum(mem.count + 1, mem.mem_size))
            mem_final = mem_final.replace(s_pending=state.mem.s_pending)
            return state.replace(x=x_new, mem=mem_final,
                                 niter=state.niter + 1), bad
        elif variant == "slab_small":
            # write cost of a SMALL dedicated recent-pair buffer: DUS
            # into grad_prev (an [n] carry leaf) stands in for a [2, n]
            # recent slot; the big ring is untouched.  Prices the
            # recent-buffer/merge redesign's per-step write.
            mem_final = mem.replace(s_pending=state.mem.s_pending)
            return state.replace(x=x_new, mem=mem_final,
                                 grad_prev=y_cand,
                                 niter=state.niter + 1), bad
        else:
            size = mem.mem_size
            st_t = mem.sy.dtype
            slab = jnp.stack([s_cand.astype(st_t), y_cand.astype(st_t)])
            new_sy = jax.lax.dynamic_update_slice_in_dim(
                mem.sy, slab, 2 * mem.head, axis=0)
            mem_final = mem.replace(
                sy=new_sy,
                head=(mem.head + 1) % size,
                count=jnp.minimum(mem.count + 1, size))
            if variant in ("full", "no_cache"):
                gram_t = mem.gram.dtype
                p = _mem_mm(new_sy, slab.T.astype(jnp.float32), gram_t)
                zero = jnp.zeros((), mem.head.dtype)
                gram = jax.lax.dynamic_update_slice(
                    mem.gram, p.astype(gram_t), (zero, 2 * mem.head))
                gram = jax.lax.dynamic_update_slice(
                    gram, p.T.astype(gram_t), (2 * mem.head, zero))
                mem_final = mem_final.replace(gram=gram)
                if variant == "full":
                    cache = _small_cache(gram, mem_final.head,
                                         mem_final.count, size,
                                         interleaved=True)
                    mem_final = mem_final.replace(**cache)

        mem_final = mem_final.replace(s_pending=state.mem.s_pending)
        return state.replace(x=x_new, mem=mem_final,
                             niter=state.niter + 1), bad

    return step


def bf16_interleaved_floor():
    """Modeled HBM-streamed bytes/step floor for bf16 flat-[2m, n]
    storage: two direction passes over the pairs + the commit's Gram pass
    (3 reads of 2m*n*2 bytes), the [2, n] slab write, two batch reads,
    and ~8 f32 n-vector streams, over the device's bandwidth from
    ``bench.PEAKS``."""
    pair = 2 * MEM * N * 2
    batch = BS * N_FEATURES * 4
    vecs = 8 * N * 4
    slab = 2 * N * 2
    total = 3 * pair + slab + 2 * batch + vecs
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import peaks
    _, peak_bw = peaks(jax.devices()[0].device_kind)
    return total, total / peak_bw * 1e6


def timed(step_fn, state, unroll=1):
    rngd = np.random.default_rng(3)
    X = jnp.asarray(rngd.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Y = jnp.asarray(np.eye(N_CLASSES)[rngd.integers(0, N_CLASSES, (B, BS))],
                    jnp.float32)

    def chain(state, data, sweeps):
        def sweep(st, _):
            def body(st2, batch):
                return step_fn(st2, batch, jnp.float32(1e-2))
            st, outs = jax.lax.scan(body, st, data, unroll=unroll)
            probe = jax.tree_util.tree_leaves(outs)[0]
            return st.replace(
                x=st.x + 1e-30 * jnp.sum(probe).astype(st.x.dtype)), ()
        return jax.lax.scan(sweep, state, None, length=sweeps)[0]

    cj = jax.jit(chain, static_argnames=("sweeps",))
    s = cj(state, (X, Y), sweeps=2)
    s = cj(s, (X, Y), sweeps=10)
    float(jnp.sum(s.x))
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        s = cj(s, (X, Y), sweeps=2)
        float(jnp.sum(s.x))
        t1 = time.perf_counter()
        s = cj(s, (X, Y), sweeps=10)
        float(jnp.sum(s.x))
        t2 = time.perf_counter()
        reps.append(((t2 - t1) - (t1 - t0)) / (8 * B))
    return sorted(reps)[2] * 1e6


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16-interleaved", action="store_true",
                    help="run the ladder in the production oLBFGS opt-in "
                         "configuration (pairs_bf16 + pairs_interleaved)")
    args = ap.parse_args()

    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((B, BS, N_FEATURES)), jnp.float32)
    Y = jnp.asarray(np.eye(N_CLASSES)[rng.integers(0, N_CLASSES, (B, BS))],
                    jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(N), jnp.float32)

    if args.bf16_interleaved:
        nbytes, floor_us = bf16_interleaved_floor()
        print(f"bf16+interleaved modeled HBM floor: {nbytes / 1e6:.1f} "
              f"MB/step = {floor_us:.1f} us/step (L2-resident passes "
              "would be lower)", flush=True)
        cfg = OLBFGSConfig.create(mem_size=MEM, min_curvature=None,
                                  pairs_bf16=True, pairs_interleaved=True)
        tr = FusedTrainer("oLBFGS", cfg, grad_fn, donate=True)
        warm, _ = tr.jit_epoch()(tr.init(x0), (X, Y), jnp.float32(1e-2))

        def production(state, batch, step_size):
            return olbfgs_step(cfg, grad_fn, state, batch, step_size)

        print(f"{'production':12s}: {timed(production, warm):7.1f} "
              "us/step", flush=True)
        # inner-scan unroll: oLBFGS mutates the ring EVERY step, so the
        # scan-carry DUS copy cost (flagship attribution: ~139 us per
        # boundary for SQN) applies per STEP here — unrolling may pay
        # where it measured negative for SQN (unroll_sweep.py)
        for k in (2, 4, 8):
            us = timed(functools.partial(olbfgs_step, cfg, grad_fn),
                       warm, unroll=k)
            print(f"{'prod_unroll' + str(k):12s}: {us:7.1f} us/step",
                  flush=True)
        for variant in ("full", "one_grad", "no_commit", "slab_only",
                        "no_cache", "slab_shift", "slab_small",
                        "gram_old_buf"):
            us = timed(variant_step_interleaved(cfg, variant), warm)
            print(f"{variant:12s}: {us:7.1f} us/step", flush=True)
        return

    cfg = OLBFGSConfig.create(mem_size=MEM, min_curvature=None)
    tr = FusedTrainer("oLBFGS", cfg, grad_fn, donate=True)
    warm, _ = tr.jit_epoch()(tr.init(x0), (X, Y), jnp.float32(1e-2))

    def production(state, batch, step_size):
        return olbfgs_step(cfg, grad_fn, state, batch, step_size)

    print(f"{'production':12s}: {timed(production, warm):7.1f} us/step",
          flush=True)
    for variant in ("full", "one_grad", "no_commit", "rows_only",
                    "no_cache"):
        us = timed(variant_step(cfg, variant), warm)
        print(f"{variant:12s}: {us:7.1f} us/step", flush=True)

    scfg = SQNConfig.create(mem_size=MEM, bfgs_upd_freq=20)
    stro = FusedTrainer("SQN", scfg, grad_fn, donate=True)
    swarm, _ = stro.jit_epoch()(stro.init(x0), (X, Y), jnp.float32(1e-2),
                                aligned=True)
    us = timed(functools.partial(_sqn_base, scfg, grad_fn), swarm)
    print(f"{'sqn_base':12s}: {us:7.1f} us/step", flush=True)


if __name__ == "__main__":
    main()
