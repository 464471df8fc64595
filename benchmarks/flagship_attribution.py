"""Decompose the flagship SQN step into named contributions by differencing
program variants.

Methodology:

  * Every variant is a SINGLE jitted multi-epoch program (no host work
    inside the timed window).
  * Each variant is timed at TWO program sizes and the per-step cost is
    the DIFFERENCE quotient (3360 vs 960 steps = 2400 differenced steps),
    which cancels the fixed per-dispatch cost.
  * Repetitions are INTERLEAVED across variants (rep k of every variant
    adjacent in time) and the median difference is reported.

Variant ladder (all at the flagship BibTeX shape, f32, m=10, L=20):

  full           the production engine (round-chunked epochs + boundary)
  base_only      per-step work only: grad + cached two-loop + guard +
                 updates; memory never changes (no boundary, no jvp)
  base_noguard   base_only with check_nan=False (prices direction_is_bad)
  grad_only      d = g (two-loop skipped), same guard + updates
  twoloop_only   g = x alias (gradient skipped), same two-loop + updates
  updates_only   g = x, d = g: guard + x/x_sum updates + scan machinery
  scan_min       [8]-carry trivial body: pure backend while-loop floor

Attribution (by subtraction; the residue is reported, not hidden):

  boundary/L = full - base_only          gradient = base_only - twoloop_only
  two-loop   = base_only - grad_only     guard    = base_only - base_noguard
  floor      = updates_only              backend  = scan_min

Writes results/flagship_attribution.json and prints the table.  A
profiler trace is the better instrument on the GPU (ROADMAP A3); not yet
run on the H100.  Reference for what is being decomposed: the
per-iteration work of ``run_SQN`` (``src/stochqn.c:1050-1073``) plus the
every-L correction pair (``:1078-1141``).
"""
import functools
import json
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

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer, _sqn_base
from stochqn_tpu.models import losses
from stochqn_tpu.ops.pairs import conditional_flush, direction_is_bad
from stochqn_tpu.ops.two_loop import two_loop_cached

# flagship shape (bench.py)
N_FEATURES, N_CLASSES, BATCH_SIZE = 1836, 159, 50
NUM_BATCHES, UPD_FREQ, MEM_SIZE = 120, 20, 10
REG, STEP = 1e-1, 1e-2
DTYPE = jnp.float32

EPOCHS_SMALL, EPOCHS_BIG = 8, 28          # diff = 2400 steps
N_ROUNDS = 5


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
    trainer = FusedTrainer("SQN", cfg, grad_fn)
    return trainer, cfg, grad_fn, trainer.init(x0), (X, Y)


def _epochs_program(step_body, nepochs):
    """Multi-epoch scan around a per-batch step body (state, batch, eta)."""
    @jax.jit
    def run(state, data, eta):
        def epoch(c, _):
            def bstep(c2, batch):
                return step_body(c2, batch, eta)
            c, _ = jax.lax.scan(bstep, c, data)
            return c, jnp.zeros((), jnp.int32)
        state2, _ = jax.lax.scan(epoch, state, None, length=nepochs)
        return state2
    return run


def _variant_bodies(cfg, grad_fn):
    """Step bodies sharing the exact update/guard structure of _sqn_base,
    with one stage knocked out each (see module docstring)."""
    import dataclasses
    cfg_noguard = dataclasses.replace(cfg, check_nan=False)

    def base_only(st, batch, eta):
        st, _bad = _sqn_base(cfg, grad_fn, st, batch, eta)
        return st, ()

    def base_noguard(st, batch, eta):
        st, _bad = _sqn_base(cfg_noguard, grad_fn, st, batch, eta)
        return st, ()

    def _tail(st, d, eta):
        bad = direction_is_bad(d)
        x_new = jnp.where(bad, st.x, st.x - eta * d)
        mem = conditional_flush(st.mem, bad)
        return st.replace(x=x_new, mem=mem, niter=st.niter + 1,
                          x_sum=st.x_sum + x_new,
                          section=jnp.int32(1)), ()

    def grad_only(st, batch, eta):          # two-loop skipped
        g = grad_fn(st.x, batch)
        return _tail(st, g, eta)

    def twoloop_only(st, batch, eta):       # gradient skipped (g = x alias)
        d = two_loop_cached(st.x, st.mem, collapsed=True)
        return _tail(st, d, eta)

    def updates_only(st, batch, eta):       # guard + updates + scan only
        return _tail(st, st.x, eta)

    def twoloop_one_pass(st, batch, eta):
        # ONE [2m, n] pass (projection only): prices the marginal pass.
        from stochqn_tpu.ops.two_loop import _mem_mm
        mem = st.mem
        w = jnp.concatenate([mem.s, mem.y], axis=0)
        wg = _mem_mm(w, st.x, mem.bwd_inv.dtype)
        d = st.x * wg[0].astype(st.x.dtype)      # keep the pass live
        return _tail(st, d, eta)

    def twoloop_vpu_expand(st, batch, eta):
        # full collapsed two-loop, but the EXPAND pass as a broadcast-
        # multiply + row reduction instead of a [1,2m]x[2m,n] matmul —
        # probes whether the matmul form's second pass costs more than
        # the first because of its layout/transpose.
        from stochqn_tpu.ops.two_loop import _mem_mm
        mem = st.mem
        g = st.x                    # gradient skipped, like twoloop_only
        acc_t = mem.bwd_inv.dtype
        w = jnp.concatenate([mem.s, mem.y], axis=0)
        gamma = jnp.where(mem.count > 0, mem.gamma,
                         jnp.ones_like(mem.gamma))
        c = mem.c0 + gamma * mem.cg
        wg = _mem_mm(w, g, acc_t)
        u = jnp.matmul(c, wg, preferred_element_type=acc_t)
        d_acc = gamma * g.astype(acc_t) \
            + jnp.sum(u[:, None] * w.astype(acc_t), axis=0)
        d = jnp.where(mem.count > 0, d_acc, g.astype(acc_t)).astype(g.dtype)
        return _tail(st, d, eta)

    def twoloop_wt_expand(st, batch, eta):
        # expand pass from a TRANSPOSED pair memory: [n, 2m] @ [2m]
        # (minor-dim contraction, n-major output) instead of u @ [2m, n]
        # (major-dim contraction).  W is loop-invariant in this probe, so
        # w.T hoists out of the scan — modeling a commit-maintained
        # transposed cache.  If this makes the second pass as cheap as
        # the first, the cache is worth its storage at streaming scale.
        from stochqn_tpu.ops.two_loop import _mem_mm
        mem = st.mem
        g = st.x
        acc_t = mem.bwd_inv.dtype
        w = jnp.concatenate([mem.s, mem.y], axis=0)
        w_t = w.T                                   # hoisted (invariant)
        gamma = jnp.where(mem.count > 0, mem.gamma,
                          jnp.ones_like(mem.gamma))
        c = mem.c0 + gamma * mem.cg
        wg = _mem_mm(w, g, acc_t)
        u = jnp.matmul(c, wg, preferred_element_type=acc_t)
        d_acc = gamma * g.astype(acc_t) + _mem_mm(w_t, u, acc_t)
        d = jnp.where(mem.count > 0, d_acc, g.astype(acc_t)).astype(g.dtype)
        return _tail(st, d, eta)

    def twoloop_no_small(st, batch, eta):
        # TWO passes, tiny c-matmul skipped: prices the small math chain.
        from stochqn_tpu.ops.two_loop import _mem_mm
        mem = st.mem
        w = jnp.concatenate([mem.s, mem.y], axis=0)
        acc_t = mem.bwd_inv.dtype
        wg = _mem_mm(w, st.x, acc_t)
        d = (mem.gamma * st.x.astype(acc_t)
             + _mem_mm(wg, w, acc_t)).astype(st.x.dtype)
        return _tail(st, d, eta)

    return {
        "base_only": base_only,
        "base_noguard": base_noguard,
        "grad_only": grad_only,
        "twoloop_only": twoloop_only,
        "twoloop_one_pass": twoloop_one_pass,
        "twoloop_no_small": twoloop_no_small,
        "twoloop_vpu_expand": twoloop_vpu_expand,
        "twoloop_wt_expand": twoloop_wt_expand,
        "updates_only": updates_only,
    }


def _round_bodies(cfg, grad_fn):
    """Round-level variants that decompose the BOUNDARY (every-L work):
    jvp Hessian-vector product vs commit small-math (triangular
    inversions etc. in ops/pairs.commit_pair's cache build).  Each is an
    epoch-shaped scan over rounds of [L, bs, ...] batches, mirroring
    FusedTrainer.round."""
    from stochqn_tpu.fused import _flat, _sqn_boundary
    from stochqn_tpu.ops.pairs import commit_pair

    L = cfg.upd_freq

    def _base_scan(st, round_data, eta):
        def inner(st2, batch):
            st2, bad = _sqn_base(cfg, grad_fn, st2, batch, eta)
            return st2, bad
        return jax.lax.scan(inner, st, round_data)

    def round_full(st, round_data, eta):
        st, bads = _base_scan(st, round_data, eta)
        st, _ = _sqn_boundary(cfg, grad_fn, st, _flat(round_data),
                              bads[-1])
        return st, ()

    def round_jvp_only(st, round_data, eta):
        # boundary minus commit: jvp runs, result folded in cheaply
        st, bads = _base_scan(st, round_data, eta)
        big = _flat(round_data)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        hv = jax.jvp(lambda xx: grad_fn(xx, big), (x_avg,), (s_cand,))[1]
        st = st.replace(grad_prev=hv, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    def round_commit_only(st, round_data, eta):
        # boundary minus jvp: commit runs with a synthetic y
        st, bads = _base_scan(st, round_data, eta)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        mem_p = st.mem.replace(s_pending=s_cand)
        mem2, acc = commit_pair(mem_p, s_cand * 1.001 + st.x * 1e-6,
                                cfg.min_curvature, y_reg=0.0,
                                direction_cache=True,
                                enabled=st.niter > L)
        st = st.replace(mem=mem2, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    def round_base(st, round_data, eta):
        st, _bads = _base_scan(st, round_data, eta)
        return st, ()

    def round_commit_nocache(st, round_data, eta):
        # commit with the collapsed-direction (c0/cg) chain OFF: prices
        # that chain.  (Timing probe only: the base steps then read a
        # zero collapsed cache, which changes the trajectory, not the
        # per-op structure being timed.)
        st, bads = _base_scan(st, round_data, eta)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        mem_p = st.mem.replace(s_pending=s_cand)
        mem2, acc = commit_pair(mem_p, s_cand * 1.001 + st.x * 1e-6,
                                cfg.min_curvature, y_reg=0.0,
                                direction_cache=False,
                                enabled=st.niter > L)
        st = st.replace(mem=mem2, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    def round_commit_gram_only(st, round_data, eta):
        # the commit's O(n) work only (ring write + incremental Gram
        # pass); the whole _small_cache skipped (stale cache reused)
        from stochqn_tpu.ops.two_loop import _mem_mm
        st, bads = _base_scan(st, round_data, eta)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        y_cand = s_cand * 1.001 + st.x * 1e-6
        mem = st.mem
        size = mem.mem_size
        new_s = jax.lax.dynamic_update_index_in_dim(
            mem.s, s_cand.astype(mem.s.dtype), mem.head, axis=0)
        new_y = jax.lax.dynamic_update_index_in_dim(
            mem.y, y_cand.astype(mem.y.dtype), mem.head, axis=0)
        w_new = jnp.concatenate([new_s, new_y], axis=0)
        p = _mem_mm(w_new, jnp.stack([s_cand, y_cand], axis=1),
                    mem.gram.dtype)
        gram = jax.lax.dynamic_update_index_in_dim(
            mem.gram, p[:, 0], mem.head, axis=1)
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 1], size + mem.head, axis=1)
        mem = mem.replace(s=new_s, y=new_y, gram=gram,
                          head=(mem.head + 1) % size,
                          count=jnp.minimum(mem.count + 1, size))
        st = st.replace(mem=mem, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    def round_commit_rows_only(st, round_data, eta):
        # ONLY the ring-row writes (carry-mutating DUS into [m, n] s/y)
        st, bads = _base_scan(st, round_data, eta)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        y_cand = s_cand * 1.001 + st.x * 1e-6
        mem = st.mem
        size = mem.mem_size
        new_s = jax.lax.dynamic_update_index_in_dim(
            mem.s, s_cand.astype(mem.s.dtype), mem.head, axis=0)
        new_y = jax.lax.dynamic_update_index_in_dim(
            mem.y, y_cand.astype(mem.y.dtype), mem.head, axis=0)
        mem = mem.replace(s=new_s, y=new_y,
                          head=(mem.head + 1) % size,
                          count=jnp.minimum(mem.count + 1, size))
        st = st.replace(mem=mem, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    def round_commit_p_only(st, round_data, eta):
        # ONLY the Gram refresh pass (reads the whole pair memory), no
        # ring-row writes
        from stochqn_tpu.ops.two_loop import _mem_mm
        st, bads = _base_scan(st, round_data, eta)
        inv_l = jnp.asarray(1.0 / L, st.x.dtype)
        x_avg = st.x_sum * inv_l
        s_cand = x_avg - st.x_avg_prev
        y_cand = s_cand * 1.001 + st.x * 1e-6
        mem = st.mem
        size = mem.mem_size
        w = jnp.concatenate([mem.s, mem.y], axis=0)
        p = _mem_mm(w, jnp.stack([s_cand, y_cand], axis=1), mem.gram.dtype)
        gram = jax.lax.dynamic_update_index_in_dim(
            mem.gram, p[:, 0], mem.head, axis=1)
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 1], size + mem.head, axis=1)
        mem = mem.replace(gram=gram,
                          head=(mem.head + 1) % size,
                          count=jnp.minimum(mem.count + 1, size))
        st = st.replace(mem=mem, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
        return st, ()

    return {
        "round_full": round_full,
        "round_jvp_only": round_jvp_only,
        "round_commit_only": round_commit_only,
        "round_commit_nocache": round_commit_nocache,
        "round_commit_gram_only": round_commit_gram_only,
        "round_commit_rows_only": round_commit_rows_only,
        "round_commit_p_only": round_commit_p_only,
        "round_base": round_base,
    }


def main():
    trainer, cfg, grad_fn, state0, data = build()
    eta = jnp.asarray(STEP, DTYPE)

    # warm state: one full epoch commits pairs so every variant's two-loop
    # runs the real direction path (count = m after 6 boundaries)
    warm_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
    state, _ = warm_fn(state0, data, eta, aligned=True)
    float(jnp.sum(state.x))

    programs = {}
    # full engine at both sizes (the production jit_epochs program)
    epochs_fn = trainer.jit_epochs()
    for ne in (EPOCHS_SMALL, EPOCHS_BIG):
        programs[("full", ne)] = functools.partial(
            epochs_fn, nepochs=ne, aligned=True)
    for name, body in _variant_bodies(cfg, grad_fn).items():
        for ne in (EPOCHS_SMALL, EPOCHS_BIG):
            programs[(name, ne)] = _epochs_program(body, ne)
    for name, body in _round_bodies(cfg, grad_fn).items():
        for ne in (EPOCHS_SMALL, EPOCHS_BIG):
            programs[(name, ne)] = _epochs_program(body, ne)

    # full engine with the ROUNDS UNROLLED inside the epoch body (the
    # boundary's ring-row DUS then sits in straight-line code where XLA
    # can update in place, instead of inside the round-scan carry where
    # the probes price it at ~150 us/boundary of buffer copying)
    rounds_n_ = NUM_BATCHES // UPD_FREQ

    def _full_unrolled(nepochs):
        @jax.jit
        def run(state, data_r, eta):
            def epoch(st, _):
                for r in range(rounds_n_):
                    rd = jax.tree_util.tree_map(lambda a, _r=r: a[_r],
                                                data_r)
                    st, _ = trainer.round(st, rd, eta)
                return st, jnp.zeros((), jnp.int32)
            st, _ = jax.lax.scan(epoch, state, None, length=nepochs)
            return st
        return run

    for ne in (EPOCHS_SMALL, EPOCHS_BIG):
        programs[("full_unrolled", ne)] = _full_unrolled(ne)

    # scan_min: trivial [8]-carry body, same trip counts
    for ne in (EPOCHS_SMALL, EPOCHS_BIG):
        @jax.jit
        def scan_min(v, data, eta, _ne=ne):
            def epoch(c, _):
                def bstep(c2, _b):
                    return c2 - eta * c2, ()
                c, _ = jax.lax.scan(bstep, c, None, length=NUM_BATCHES)
                return c, jnp.zeros((), jnp.int32)
            v2, _ = jax.lax.scan(epoch, v, None, length=_ne)
            return v2
        programs[("scan_min", ne)] = scan_min

    v8 = jnp.ones((8,), DTYPE)
    rounds_n = NUM_BATCHES // UPD_FREQ
    data_r = jax.tree_util.tree_map(
        lambda a: a.reshape((rounds_n, UPD_FREQ) + a.shape[1:]), data)

    def run_once(key):
        name, ne = key
        t0 = time.perf_counter()
        if name == "full":
            out, _ = programs[key](state, data, eta)
            float(jnp.sum(out.x))
        elif name == "scan_min":
            out = programs[key](v8, data, eta)
            float(jnp.sum(out))
        elif name.startswith("round_") or name == "full_unrolled":
            out = programs[key](state, data_r, eta)
            float(jnp.sum(out.x))
        else:
            out = programs[key](state, data, eta)
            float(jnp.sum(out.x))
        return time.perf_counter() - t0

    names = ["full", "full_unrolled", "base_only", "base_noguard",
             "grad_only",
             "twoloop_only", "twoloop_one_pass", "twoloop_no_small",
             "twoloop_vpu_expand", "twoloop_wt_expand",
             "updates_only", "scan_min",
             "round_full", "round_jvp_only", "round_commit_only",
             "round_commit_nocache", "round_commit_gram_only",
             "round_commit_rows_only", "round_commit_p_only",
             "round_base"]

    # compile + warm every program once
    for key in programs:
        run_once(key)

    # interleaved rounds: rep k of every (variant, size) adjacent in time
    times = {key: [] for key in programs}
    for _ in range(N_ROUNDS):
        for name in names:
            for ne in (EPOCHS_SMALL, EPOCHS_BIG):
                times[(name, ne)].append(run_once((name, ne)))

    diff_steps = (EPOCHS_BIG - EPOCHS_SMALL) * NUM_BATCHES
    us = {}
    for name in names:
        per_round = [(b - s) / diff_steps * 1e6
                     for s, b in zip(times[(name, EPOCHS_SMALL)],
                                     times[(name, EPOCHS_BIG)])]
        us[name] = {
            "us_per_step_median": round(statistics.median(per_round), 2),
            "rounds": [round(v, 2) for v in per_round],
        }

    m = {k: v["us_per_step_median"] for k, v in us.items()}
    attribution = {
        "total_full": m["full"],
        "boundary_per_iter": round(m["full"] - m["base_only"], 2),
        "gradient": round(m["base_only"] - m["twoloop_only"], 2),
        "two_loop": round(m["base_only"] - m["grad_only"], 2),
        "guard": round(m["base_only"] - m["base_noguard"], 2),
        "updates_plus_scan": m["updates_only"],
        "backend_scan_floor": m["scan_min"],
        # grad + two-loop + (updates+scan) should rebuild base_only;
        # what's left is overlap/interaction between the stages
        "base_residue_interaction": round(
            m["base_only"] - ((m["base_only"] - m["twoloop_only"])
                              + (m["base_only"] - m["grad_only"])
                              + m["updates_only"]), 2),
        # candidate fixes, measured head-to-head with the engine
        "full_unrolled_rounds": m["full_unrolled"],
        "vpu_expand_vs_matmul_expand": round(
            m["twoloop_vpu_expand"] - m["twoloop_only"], 2),
        "wt_expand_vs_matmul_expand": round(
            m["twoloop_wt_expand"] - m["twoloop_only"], 2),
        # two-loop internals (per step): first pass, marginal second
        # pass, and the tiny-matvec chain between them
        "twoloop_first_pass": round(
            m["twoloop_one_pass"] - m["updates_only"], 2),
        "twoloop_second_pass": round(
            m["twoloop_no_small"] - m["twoloop_one_pass"], 2),
        "twoloop_small_math": round(
            m["twoloop_only"] - m["twoloop_no_small"], 2),
        # boundary internals (per BOUNDARY, i.e. x upd_freq)
        "per_boundary_us": {
            "total": round((m["round_full"] - m["round_base"]) * UPD_FREQ,
                           1),
            "jvp": round((m["round_jvp_only"] - m["round_base"])
                         * UPD_FREQ, 1),
            "commit_total": round(
                (m["round_commit_only"] - m["round_base"]) * UPD_FREQ, 1),
            "commit_gram_pass_o_n": round(
                (m["round_commit_gram_only"] - m["round_base"])
                * UPD_FREQ, 1),
            "commit_collapsed_cache_chain": round(
                (m["round_commit_only"] - m["round_commit_nocache"])
                * UPD_FREQ, 1),
            "commit_small_cache_base": round(
                (m["round_commit_nocache"]
                 - m["round_commit_gram_only"]) * UPD_FREQ, 1),
            "commit_ring_row_writes": round(
                (m["round_commit_rows_only"] - m["round_base"])
                * UPD_FREQ, 1),
            "commit_gram_refresh_pass": round(
                (m["round_commit_p_only"] - m["round_base"])
                * UPD_FREQ, 1),
        },
    }

    out = {
        "device": jax.devices()[0].device_kind,
        "shape": {"n_features": N_FEATURES, "n_classes": N_CLASSES,
                  "batch_size": BATCH_SIZE, "num_batches": NUM_BATCHES,
                  "upd_freq": UPD_FREQ, "mem_size": MEM_SIZE},
        "epochs": [EPOCHS_SMALL, EPOCHS_BIG],
        "diff_steps": diff_steps,
        "variants_us_per_step": us,
        "attribution_us": attribution,
    }
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "flagship_attribution.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["attribution_us"], indent=1))
    print("full table ->", path)


if __name__ == "__main__":
    main()
