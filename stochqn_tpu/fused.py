"""Fused on-device training engine.

This is the on-device execution mode the reference cannot offer: instead of
bouncing a request/response protocol across the host boundary on every
gradient (``stochqn/_optimizers.py:339-382`` + Cython + C), the user's loss
/ gradient functions are JAX callables and an entire optimizer iteration —
including two-loop direction, step, averaging, big-batch gradients,
``jax.jvp`` Hessian-vector products, Fisher products and all accept/reject
logic — is traced into jitted ``lax.scan``s.  State stays in HBM; there is
zero host synchronization inside an epoch.

Performance structure: when ``batches_per_epoch`` is a multiple of
``upd_freq`` (the common benchmark setup and the default epoch layout), the
epoch runs as a scan over *rounds* — an inner scan of ``upd_freq`` cheap
base steps (gradient + cached two-loop + update: no branches, no big-array
conds) followed by the boundary work (big-batch gradient / Hessian-vector /
function-value guard + pair commit) exactly once.  Keeping ``lax.cond`` out
of the hot loop matters: a cond that carries the ``[m, n]`` pair memories
forces full-buffer copies every iteration.  A generic per-step path with
the boundary under ``lax.cond`` remains for non-divisible layouts.

Semantics are protocol-equivalent to the free-mode state machines (tested
against them), with these documented differences:

  * Big batches are exactly the last ``upd_freq`` minibatches (in the
    round-chunked layout: the round's batches) — the reference slices a
    contiguous chunk and falls back to a stored-batch container when
    misaligned (``stochqn/_optimizers.py:55-79``).  When aligned, the two
    coincide.  In the misaligned generic path the cyclic window can wrap
    into this epoch's not-yet-consumed batches — the same shortcut the
    reference's ``_get_long_batch`` takes ("it's faster to just take a
    larger continuous sample", ``stochqn/_optimizers.py:66-69``).
  * Epoch shuffling uses ``jax.random.permutation`` on device rather than
    host-side numpy shuffling.

Hessian-vector products come from forward-over-reverse ``jax.jvp`` of the
user's gradient function — no hand-written ``hess_vec_fun`` needed
(reference requires one: ``stochqn/_optimizers.py:544-550``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from stochqn_tpu.core import adaqn, olbfgs, sqn
from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.core.enums import Info
from stochqn_tpu.core.state import AdaQNState, OLBFGSState, SQNState
from stochqn_tpu.ops.accumulators import diag_rescal
from stochqn_tpu.ops.pairs import (commit_pair, conditional_flush,
                                   direction_is_bad, fisher_y)
from stochqn_tpu.ops.two_loop import two_loop_cached

Batch = Any  # pytree of arrays with a leading example axis
GradFn = Callable[[jax.Array, Batch], jax.Array]
ObjFn = Callable[[jax.Array, Batch], jax.Array]
# Optional analytic Hessian-vector product: ``hess_vec_fn(x, v, batch) -> [n]``
# (the reference's user-supplied ``hess_vec_fun`` callback,
# ``src/stochqn.c:1105-1111``).  When absent the engine uses
# forward-over-reverse ``jax.jvp`` of ``grad_fn`` — always correct; an
# analytic form can be cheaper (e.g. logistic: 2 matmuls vs jvp's ~4).
HessVecFn = Callable[[jax.Array, jax.Array, Batch], jax.Array]

_NO_PROB = jnp.int32(Info.NO_PROBLEMS_ENCOUNTERED)
_NAN = jnp.int32(Info.SEARCH_DIRECTION_WAS_NAN)
_CURV = jnp.int32(Info.CURVATURE_TOO_SMALL)
_FINC = jnp.int32(Info.FUNC_INCREASED)


def _info(bad, accepted_or_none=None):
    info = jnp.where(bad, _NAN, _NO_PROB)
    if accepted_or_none is not None:
        info = jnp.where(accepted_or_none, info, _CURV)
    return info


def _flat(batch):
    """Merge a [k, bs, ...] stack of minibatches into one big batch.

    The merge keeps the (possibly data-sharded) example axis MAJOR:
    reshaping ``[k, bs, ...] -> [k*bs, ...]`` with ``bs`` sharded would
    interleave shards along the merged axis — a sharding GSPMD cannot
    represent, so it materializes an all-gather of the whole stack (the
    compiled HLO shows it; ``parallel.hlo_stats`` counts the bytes).
    ``[bs, k, ...] -> [bs*k, ...]`` keeps each device's rows contiguous
    and collective-free.  Big batches are consumed only
    through sample means (gradients / jvp / function values), which are
    order-invariant up to float reduction order.
    """
    def merge(a):
        a = jnp.swapaxes(a, 0, 1)
        return a.reshape((-1,) + a.shape[2:])
    return jax.tree_util.tree_map(merge, batch)


# ===========================================================================
# oLBFGS
# ===========================================================================
def olbfgs_step(cfg: OLBFGSConfig, grad_fn: GradFn, state: OLBFGSState,
                batch: Batch, step_size) -> Tuple[OLBFGSState, jax.Array]:
    """One full oLBFGS iteration (two same-batch gradient evaluations).

    Fuses protocol sections 1+2 of ``run_oLBFGS``
    (``src/stochqn.c:991-1031``)."""
    step_size = jnp.asarray(step_size, state.x.dtype)
    g = grad_fn(state.x, batch)
    d = two_loop_cached(g, state.mem, h0=cfg.hess_init)
    bad = direction_is_bad(d) if cfg.check_nan else jnp.zeros((), bool)

    s_cand = -step_size * d
    x_new = jnp.where(bad, state.x, state.x + s_cand)
    mem = conditional_flush(state.mem.replace(s_pending=s_cand), bad)

    g2 = grad_fn(x_new, batch)             # same batch, new x
    mem_final, accepted = commit_pair(mem, g2 - g, cfg.min_curvature,
                                      cfg.y_reg,
                                      enabled=jnp.logical_not(bad))

    # grad_prev and s_pending are dead across fused steps (the pair is
    # built within the step), and at any protocol resume point
    # (section 1) both are rewritten before being read — so they stay
    # PASS-THROUGH in the scan carry: each mutated [n] carry leaf is one
    # more buffer write per step.
    mem_final = mem_final.replace(s_pending=state.mem.s_pending)
    state = state.replace(x=x_new, mem=mem_final,
                          niter=state.niter + 1,
                          section=jnp.int32(1))
    return state, _info(bad, jnp.where(bad, True, accepted))


def _olbfgs_epoch_paired(cfg: OLBFGSConfig, grad_fn: GradFn, state,
                         data, step_size, unroll: int = 1):
    """Software-pipelined oLBFGS epoch: ONE batched gradient evaluation per
    step instead of two.

    Protocol oLBFGS evaluates two gradients per iteration
    (``src/stochqn.c:991-1031``): ``g = grad(x_k, b_k)`` before the step and
    ``g2 = grad(x_{k+1}, b_k)`` after it (same batch, new iterate).  But
    ``x_{k+1}`` is exactly where iteration ``k+1`` evaluates
    ``grad(x_{k+1}, b_{k+1})`` — so the pair ``(g2_k, g_{k+1})`` shares one
    evaluation point and fuses into a single ``jax.vmap`` over the stacked
    ``[2, bs, ...]`` batch: every matmul in the user's gradient becomes one
    batched op instead of two sequential ones.

    Off by default: on the earlier accelerator (PERF.md) it was slower
    than the sequential layout on the flagship workload (the batch-2
    dot_generals and doubled batch reads cost more than the dispatch they
    save).  Not measured on the H100 (``benchmarks/olbfgs_paired.py``
    compares the two).

    The pair commit for iteration ``k`` is therefore deferred into iteration
    ``k+1`` (it uses ``g2_k`` from the fused call, *before* the two-loop
    direction — the same ordering as the sequential step, where pair ``k``
    lands in memory before direction ``k+1`` reads it).  The epoch ends with
    a one-gradient epilogue committing the final pending pair, so the state
    returned at the epoch boundary is exactly the sequential one.
    Trajectory identity with :func:`olbfgs_step` is locked by
    ``tests/test_fused.py::test_olbfgs_paired_matches_sequential``.
    """
    step_size = jnp.asarray(step_size, state.x.dtype)
    # [B, 2, bs, ...]: row k pairs batch k-1 (the pending commit's batch)
    # with batch k — built once, so the scan body slices ONE leaf per input
    # instead of slicing two and stacking them per step.
    paired = jax.tree_util.tree_map(
        lambda a: jnp.stack([jnp.roll(a, 1, axis=0), a], axis=1), data)

    def body(carry, stacked):
        st, pend_g, pend_enabled = carry
        g_pair = jax.vmap(grad_fn, in_axes=(None, 0))(st.x, stacked)
        g2_prev, g = g_pair[0], g_pair[1]

        # finish iteration k-1: commit its (s, y) pair (vetoed on the first
        # step of the epoch and after a rejected direction)
        mem, acc_prev = commit_pair(st.mem, g2_prev - pend_g,
                                    cfg.min_curvature, cfg.y_reg,
                                    enabled=pend_enabled)

        # iteration k proper (same math as olbfgs_step)
        d = two_loop_cached(g, mem, h0=cfg.hess_init)
        bad = (direction_is_bad(d) if cfg.check_nan
               else jnp.zeros((), bool))
        s_cand = -step_size * d
        x_new = jnp.where(bad, st.x, st.x + s_cand)
        # s_pending IS live across paired steps (next step's deferred
        # commit reads it); grad_prev is not (the pending gradient rides
        # the explicit carry) and stays pass-through like in olbfgs_step
        mem = conditional_flush(mem.replace(s_pending=s_cand), bad)
        st = st.replace(x=x_new, mem=mem,
                        niter=st.niter + 1, section=jnp.int32(1))
        return (st, g, jnp.logical_not(bad)), (bad, acc_prev)

    zero_g = jnp.zeros_like(state.x)
    (st, pend_g, pend_enabled), (bads, acc_prevs) = jax.lax.scan(
        body, (state, zero_g, jnp.zeros((), bool)), paired,
        unroll=unroll)

    # epilogue: one plain gradient call commits the last pending pair
    b_last = jax.tree_util.tree_map(lambda a: a[-1], data)
    g2_last = grad_fn(st.x, b_last)
    mem, acc_last = commit_pair(st.mem, g2_last - pend_g,
                                cfg.min_curvature, cfg.y_reg,
                                enabled=pend_enabled)
    st = st.replace(mem=mem)

    accs = jnp.concatenate([acc_prevs[1:], acc_last[None]])
    infos = jnp.where(bads, _NAN, jnp.where(accs, _NO_PROB, _CURV))
    return st, infos


# ===========================================================================
# SQN
# ===========================================================================
def _sqn_base(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
              batch: Batch, step_size) -> Tuple[SQNState, jax.Array]:
    """The per-iteration work of ``run_SQN`` section 1 before any
    ``upd_freq`` boundary (``src/stochqn.c:1050-1073``)."""
    g = grad_fn(state.x, batch)
    d = two_loop_cached(g, state.mem, collapsed=True)
    bad = direction_is_bad(d) if cfg.check_nan else jnp.zeros((), bool)
    x_new = jnp.where(bad, state.x, state.x - step_size * d)
    mem = conditional_flush(state.mem, bad)
    state = state.replace(x=x_new, mem=mem, niter=state.niter + 1,
                          x_sum=state.x_sum + x_new, section=jnp.int32(1))
    return state, bad


def _sqn_boundary(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
                  big: Batch, bad,
                  hess_vec_fn: Optional[HessVecFn] = None
                  ) -> Tuple[SQNState, jax.Array]:
    """The every-``upd_freq`` correction-pair work
    (``src/stochqn.c:1078-1141``).  ``big`` is the already-assembled big
    batch; must be called exactly when ``niter % upd_freq == 0``.

    Branch-free: the first-archive and later-commit cases are combined
    with scalar/[n]-sized selects and a vetoed commit — a ``lax.cond``
    here would copy the ``[m, n]`` pair memories through its carry."""
    L = cfg.upd_freq
    inv_l = jnp.asarray(1.0 / L, state.x.dtype)
    st = state
    x_avg = st.x_sum * inv_l
    is_first = st.niter == L
    not_first = jnp.logical_not(is_first)

    s_cand = x_avg - st.x_avg_prev      # garbage on first round; vetoed
    mem_p = st.mem.replace(s_pending=s_cand)
    if cfg.use_grad_diff:
        gb = grad_fn(x_avg, big)        # first round evaluates at the
        # archived average, which equals x_avg here (src/stochqn.c:1086-1088)
        mem2, acc = commit_pair(mem_p, gb - st.grad_prev,
                                cfg.min_curvature, cfg.y_reg,
                                direction_cache=True,
                                enabled=not_first)
        st = st.replace(
            mem=mem2,
            grad_prev=jnp.where(is_first | acc, gb, st.grad_prev),
            x_avg_prev=jnp.where(is_first | acc, x_avg, st.x_avg_prev),
            x_sum=jnp.zeros_like(st.x_sum))
    else:
        if hess_vec_fn is not None:
            hv = hess_vec_fn(x_avg, s_cand, big)
        else:
            hv = jax.jvp(lambda xx: grad_fn(xx, big), (x_avg,),
                         (s_cand,))[1]
        mem2, acc = commit_pair(mem_p, hv, cfg.min_curvature, y_reg=0.0,
                                direction_cache=True,
                                enabled=not_first)
        # archive happens on first AND (accept or reject) later rounds
        st = st.replace(mem=mem2, x_avg_prev=x_avg,
                        x_sum=jnp.zeros_like(st.x_sum))
    info = jnp.where(is_first, _info(bad), _info(bad, acc))
    return st, info


def sqn_step(cfg: SQNConfig, grad_fn: GradFn, state: SQNState, batch: Batch,
             big_batch_thunk: Callable[[], Batch], step_size,
             hess_vec_fn: Optional[HessVecFn] = None
             ) -> Tuple[SQNState, jax.Array]:
    """One SQN iteration with the boundary under ``lax.cond`` — the generic
    (alignment-free) path.  Prefer the round-chunked epoch layout."""
    step_size = jnp.asarray(step_size, state.x.dtype)
    state, bad = _sqn_base(cfg, grad_fn, state, batch, step_size)
    return jax.lax.cond(
        jnp.mod(state.niter, cfg.upd_freq) == 0,
        lambda st: _sqn_boundary(cfg, grad_fn, st, big_batch_thunk(), bad,
                                 hess_vec_fn),
        lambda st: (st, _info(bad)), state)


# ===========================================================================
# adaQN
# ===========================================================================
def _adaqn_base(cfg: AdaQNConfig, grad_fn: GradFn, state: AdaQNState,
                batch: Batch, step_size
                ) -> Tuple[AdaQNState, jax.Array, jax.Array]:
    """Per-iteration adaQN work before any boundary
    (``src/stochqn.c:1170-1197``).  Returns ``(state, bad, grad)``.

    The Fisher ring append happens here, per step, like the reference
    (``src/stochqn.c:1174``).  A deferred layout (gradients emitted as
    scan outputs, one batched insert at the boundary) was slower on the
    earlier accelerator (PERF.md); not measured on the H100."""
    g = grad_fn(state.x, batch)
    if not cfg.use_grad_diff:
        state = state.replace(fisher=state.fisher.append(g))

    rescaled, acc_sq = diag_rescal(g, state.grad_sum_sq, cfg.scal_reg,
                                   cfg.rmsprop_weight)
    if cfg.h0_exact_reference:
        h0_diag = rescaled
    else:
        h0_diag = jax.lax.rsqrt(acc_sq + jnp.asarray(cfg.scal_reg,
                                                     acc_sq.dtype))
    d_mem = two_loop_cached(g, state.mem, diag=h0_diag,
                            coupling=cfg.coupling)
    d = jnp.where(state.mem.count > 0, d_mem, rescaled)
    bad = direction_is_bad(d) if cfg.check_nan else jnp.zeros((), bool)

    x_new = jnp.where(bad, state.x, state.x - step_size * d)
    mem = conditional_flush(state.mem, bad)  # Fisher NOT flushed
    state = state.replace(x=x_new, mem=mem, grad_sum_sq=acc_sq,
                          niter=state.niter + 1,
                          x_sum=state.x_sum + x_new, section=jnp.int32(1))
    return state, bad, g


def _adaqn_boundary(cfg: AdaQNConfig, grad_fn: GradFn,
                    obj_fn: Optional[ObjFn], state: AdaQNState, big: Batch,
                    fval_batch: Batch, bad) -> Tuple[AdaQNState, jax.Array]:
    """Every-``upd_freq`` adaQN work: function-value guard + pair commit
    (``src/stochqn.c:1201-1308``).

    Branch-free (see ``_sqn_boundary``): first-archive, func-increase
    rejection, and pair commit are combined with scalar/[n]-sized selects
    and a vetoed commit — no big-buffer-carrying ``lax.cond``."""
    L = cfg.upd_freq
    inv_l = jnp.asarray(1.0 / L, state.x.dtype)
    st = state
    x_avg = st.x_sum * inv_l
    is_first = st.niter == L
    not_first = jnp.logical_not(is_first)
    base_info = _info(bad)

    # --- function-value guard (src/stochqn.c:1272-1291) ---
    if cfg.max_incr > 0:
        f = jnp.asarray(obj_fn(x_avg, fval_batch), st.x.dtype)
        reject = not_first & (
            (f > jnp.asarray(cfg.max_incr, f.dtype) * st.f_prev)
            | jnp.logical_not(jnp.isfinite(f)))
        # accept (or first): record f; reject: keep f_prev
        st = st.replace(f_prev=jnp.where(reject, st.f_prev, f))
    else:
        reject = jnp.zeros((), bool)

    commit_ok = not_first & jnp.logical_not(reject)
    s_cand = x_avg - st.x_avg_prev      # garbage on first round; vetoed
    mem_p = st.mem.replace(s_pending=s_cand)

    if cfg.use_grad_diff:
        gb = grad_fn(x_avg, big)
        mem2, acc = commit_pair(mem_p, gb - st.grad_prev, cfg.min_curvature,
                                cfg.y_reg, enabled=commit_ok)
        # x_avg_prev refreshed only on the first archive (reference quirk,
        # src/stochqn.c:1265-1270).
        st = st.replace(
            mem=mem2,
            grad_prev=jnp.where(is_first | acc, gb, st.grad_prev),
            x_avg_prev=jnp.where(is_first, x_avg, st.x_avg_prev))
    else:
        y_cand = fisher_y(st.fisher, s_cand)
        mem2, acc = commit_pair(mem_p, y_cand, cfg.min_curvature, y_reg=0.0,
                                enabled=commit_ok)
        st = st.replace(
            mem=mem2,
            x_avg_prev=jnp.where(is_first | acc, x_avg, st.x_avg_prev))

    # rejection: flush both memories, revert x (src/stochqn.c:1275-1283)
    st = st.replace(
        mem=conditional_flush(st.mem, reject),
        fisher=st.fisher.replace(
            head=jnp.where(reject, jnp.int32(0), st.fisher.head),
            count=jnp.where(reject, jnp.int32(0), st.fisher.count)),
        x=jnp.where(reject, st.x_avg_prev, st.x),
        # x_sum: zeroed normally; on rejection keeps x_avg (quirk,
        # src/stochqn.c:1275-1283 — the sum is left divided)
        x_sum=jnp.where(reject, x_avg, jnp.zeros_like(st.x_sum)),
    )

    info = jnp.where(reject, _FINC,
                     jnp.where(is_first, base_info,
                               jnp.where(acc, base_info, _CURV)))
    return st, info


def adaqn_step(cfg: AdaQNConfig, grad_fn: GradFn, obj_fn: Optional[ObjFn],
               state: AdaQNState, batch: Batch,
               big_batch_thunk: Callable[[], Batch],
               fval_batch_thunk: Callable[[], Batch], step_size
               ) -> Tuple[AdaQNState, jax.Array]:
    """One adaQN iteration with the boundary under ``lax.cond`` — the
    generic (alignment-free) path."""
    if cfg.max_incr > 0 and obj_fn is None:
        raise ValueError("adaQN with max_incr needs an objective function")
    step_size = jnp.asarray(step_size, state.x.dtype)
    state, bad, _ = _adaqn_base(cfg, grad_fn, state, batch, step_size)
    return jax.lax.cond(
        jnp.mod(state.niter, cfg.upd_freq) == 0,
        lambda st: _adaqn_boundary(cfg, grad_fn, obj_fn, st,
                                   big_batch_thunk(), fval_batch_thunk(),
                                   bad),
        lambda st: (st, _info(bad)), state)


# ===========================================================================
# Epoch / training drivers
# ===========================================================================
def _cyclic_window(data, i, window, num_batches):
    """Last ``window`` batches ending at batch ``i`` (inclusive), cyclic,
    flattened back to an example axis (sharded-axis-major — see
    ``_flat``)."""
    idx = jnp.mod(i + 1 - window + jnp.arange(window), num_batches)

    def take(a):
        w = jnp.take(a, idx, axis=0)             # [window, bs, ...]
        w = jnp.swapaxes(w, 0, 1)                # [bs, window, ...]
        return w.reshape((-1,) + a.shape[2:])
    return jax.tree_util.tree_map(take, data)


def _batch_at(data, i):
    return jax.tree_util.tree_map(lambda a: a[i], data)


@dataclasses.dataclass
class FusedTrainer:
    """Scan-fused trainer for any of the three optimizers.

    Args:
      optimizer: "oLBFGS" | "SQN" | "adaQN".
      cfg: the matching config dataclass.
      grad_fn: ``grad_fn(x, batch) -> [n]`` (JAX-traceable).
      obj_fn: ``obj_fn(x, batch) -> scalar``; required for adaQN with
        ``max_incr``.
      val_data: optional pytree of device-resident validation data used for
        adaQN's function-value guard (otherwise the big batch is used,
        matching the reference's fallback).
    """

    optimizer: str
    cfg: Any
    grad_fn: GradFn
    obj_fn: Optional[ObjFn] = None
    val_data: Optional[Batch] = None
    # Optional analytic Hessian-vector product ``hess_vec_fn(x, v, big)``
    # used by SQN's boundary pair construction in place of the default
    # forward-over-reverse ``jax.jvp`` of ``grad_fn`` — the fused-engine
    # analogue of the reference's user-supplied ``hess_vec_fun`` callback
    # (``src/stochqn.c:1105-1111``; the protocol engine already takes one
    # via ``SQN(hess_vec_fun=...)``).  Ignored for oLBFGS/adaQN and when
    # ``cfg.use_grad_diff``.
    hess_vec_fn: Optional[HessVecFn] = None
    # Unroll factor for the inner per-step ``lax.scan``s (semantics-
    # preserving; lax.scan handles any factor).  ``None`` = auto:
    # 8 for oLBFGS, 1 otherwise.  Both values were chosen on the earlier
    # accelerator (PERF.md; ``benchmarks/olbfgs_unroll_ab.py``,
    # ``benchmarks/unroll_sweep.py``) and have not been measured on the
    # H100.
    unroll: Optional[int] = None
    # oLBFGS only: fuse the two per-iteration gradient evaluations into one
    # vmapped call via software pipelining (see ``_olbfgs_epoch_paired``).
    # Trajectory-identical; default off because it was slower on the
    # earlier accelerator (PERF.md).  Not measured on the H100.
    paired_grads: bool = False
    # Donate the state carry into the jitted epoch (``run_epochs`` /
    # ``jit_epoch``) so XLA reuses the ``[m, n]`` pair-memory buffers
    # in place instead of holding input+output copies of them across the
    # epoch dispatch.  This halves the peak pair-memory footprint — the
    # capacity axis at the top of the single-card range (f32 n=64M needs
    # 5.1 GB of pairs) — and is trajectory-identical (locked by
    # ``tests/test_fused.py::test_donated_epoch_trajectory_identical``).
    # The cost: the state passed INTO ``run_epochs``/the jitted epoch is
    # CONSUMED (its buffers are invalidated).  Default OFF so the public
    # API is non-consuming — callers that diff against the pre-epoch
    # iterate or re-run from a saved state keep working; opt in with
    # ``donate=True`` for the large-n capacity path (bench.py and
    # benchmarks/large_n.py do).
    donate: bool = False
    # Optional resharding hook for :meth:`jit_epochs_scheduled`: applied to
    # each epoch's gathered-and-rebatched data pytree inside the scan body.
    # The device-side gather that implements the per-epoch shuffle leaves
    # its output's sharding to GSPMD, which (in the compiled HLO of a
    # (4 data x 2 param) mesh) REPLICATES the example axis — the
    # per-epoch gather compiles to one dataset-shard all-reduce over the
    # data axis, and every device then computes full-batch gradients:
    # correct, but data parallelism is lost for the whole epoch.  Pass
    # ``parallel.epoch_batch_constraint(mesh)`` to pin the within-batch
    # example axis back onto the data mesh axis (the per-step gradient
    # all-reduce then reappears, exactly as in the pre-sharded-data
    # paths).  None = let GSPMD decide.
    batch_constraint: Optional[Callable[[Batch], Batch]] = None
    # Unroll the per-ROUND scan of the chunked epoch into straight-line
    # code (None = auto: unroll when the epoch has <= 8 rounds).  The
    # boundary commit mutates the [m, n] ring buffers through dynamic-
    # update-slices; inside a lax.scan carry XLA may copy the whole pair
    # memory first.  Unrolling turns the boundary DUS chains of an epoch
    # into consecutive straight-line updates that alias in place.  The
    # 8-round threshold was chosen on the earlier accelerator (PERF.md;
    # benchmarks/flagship_attribution.py) and has not been measured on
    # the H100.  Trajectory-identical (same ops, same order; locked by
    # tests/test_fused.py::test_unrolled_rounds_trajectory_identical).
    # The threshold bounds compile-time growth for many-round epochs.
    unroll_rounds: Optional[bool] = None

    _epoch_jit: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _epochs_jit: Any = dataclasses.field(default=None, repr=False,
                                         compare=False)
    _epochs_sched_jit: Any = dataclasses.field(default=None, repr=False,
                                               compare=False)

    def __post_init__(self):
        kind = self.optimizer
        if kind == "oLBFGS":
            assert isinstance(self.cfg, OLBFGSConfig)
        elif kind == "SQN":
            assert isinstance(self.cfg, SQNConfig)
        elif kind == "adaQN":
            assert isinstance(self.cfg, AdaQNConfig)
            if self.cfg.max_incr > 0 and self.obj_fn is None:
                raise ValueError(
                    "adaQN with max_incr needs an objective function "
                    "(pass obj_fn=..., or max_incr=None to disable the "
                    "function-value guard)")
        else:
            raise ValueError(f"unknown optimizer {kind!r}")

    @property
    def _unroll(self) -> int:
        """Resolved inner-scan unroll factor (see the field comment)."""
        if self.unroll is not None:
            return self.unroll
        return 8 if self.optimizer == "oLBFGS" else 1

    def init(self, x0):
        if self.optimizer == "oLBFGS":
            return olbfgs.init(jnp.asarray(x0), self.cfg)
        if self.optimizer == "SQN":
            return sqn.init(jnp.asarray(x0), self.cfg)
        return adaqn.init(jnp.asarray(x0), self.cfg)

    # -- single fused epoch (jit this, or let run_epochs jit it) ---------- #
    def epoch(self, state, data, step_size, aligned=None):
        """Run one epoch over ``data`` (pytree, leaves ``[B, bs, ...]``).

        Returns ``(state, infos[B])``.  Uses the round-chunked layout when
        ``B % upd_freq == 0`` (see module docstring) — valid only when
        boundaries land at round ends, i.e. ``niter % upd_freq == 0`` at
        epoch start.

        ``aligned`` is that contract, as a *static* (Python bool) argument:

          * ``True``  — caller asserts alignment; chunked layout if the
            shapes permit (fresh states + divisible epochs satisfy this).
          * ``False`` — force the generic per-step path (any ``niter``).
          * ``None``  (default) — decide automatically: checked against
            ``state.niter`` when it is concrete; under tracing the
            dispatch becomes a ``lax.cond`` on ``niter % upd_freq`` so a
            jitted ``epoch`` is protocol-correct for *any* resumed state
            (at the cost of compiling both layouts — jit with
            ``static_argnames=("aligned",)`` and pass the known value to
            avoid that; ``run_epochs`` does)."""
        num_batches = jax.tree_util.tree_leaves(data)[0].shape[0]
        L = getattr(self.cfg, "upd_freq", 1)

        if self.optimizer == "oLBFGS":
            if self.paired_grads:
                return _olbfgs_epoch_paired(self.cfg, self.grad_fn, state,
                                            data, step_size,
                                            unroll=self._unroll)

            def body(st, batch):
                return olbfgs_step(self.cfg, self.grad_fn, st, batch,
                                   step_size)
            return jax.lax.scan(body, state, data, unroll=self._unroll)

        shapes_ok = (num_batches % L == 0 and num_batches >= L)
        if not shapes_ok or aligned is False:
            return self._epoch_generic(state, data, step_size, num_batches,
                                       L)
        if aligned is None:
            try:
                aligned = int(state.niter) % L == 0
            except (TypeError, jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError):
                # niter is a tracer: dispatch at runtime.  lax.cond keeps
                # the one-copy cost at epoch (not step) granularity.
                return jax.lax.cond(
                    jnp.mod(state.niter, L) == 0,
                    lambda st: self._epoch_chunked(st, data, step_size,
                                                   num_batches, L),
                    lambda st: self._epoch_generic(st, data, step_size,
                                                   num_batches, L),
                    state)
        if aligned:
            return self._epoch_chunked(state, data, step_size, num_batches,
                                       L)
        return self._epoch_generic(state, data, step_size, num_batches, L)

    def round(self, state, round_data, step_size):
        """One ``upd_freq``-sized round: inner scan of branch-free base
        steps + the boundary work once.  ``round_data`` leaves are
        ``[upd_freq, bs, ...]``.  Must start with ``niter % upd_freq == 0``.

        Also the unit of streaming ingestion: jit this and feed successive
        rounds of minibatches (see ``stochqn_tpu.utils.data.stream_rounds``)
        — the streaming analogue of the reference's ``partial_fit``
        stored-batch container (``stochqn/_optimizers.py:288-337``)."""
        if self.optimizer == "oLBFGS":
            def inner_o(st2, batch):
                return olbfgs_step(self.cfg, self.grad_fn, st2, batch,
                                   step_size)
            return jax.lax.scan(inner_o, state, round_data,
                                unroll=self._unroll)

        L = jax.tree_util.tree_leaves(round_data)[0].shape[0]

        if self.optimizer == "SQN":
            def inner(st2, batch):
                st2, bad = _sqn_base(self.cfg, self.grad_fn, st2, batch,
                                     step_size)
                return st2, bad
        else:
            # The Fisher ring append stays per step: deferring it (emit
            # g as a scan output, one append_block at the boundary) was
            # slower on the earlier accelerator (PERF.md); not measured
            # on the H100.
            def inner(st2, batch):
                st2, bad, _g = _adaqn_base(self.cfg, self.grad_fn, st2,
                                           batch, step_size)
                return st2, bad

        st, bads = jax.lax.scan(inner, state, round_data,
                                unroll=self._unroll)
        big = _flat(round_data)
        if self.optimizer == "SQN":
            st, binfo = _sqn_boundary(self.cfg, self.grad_fn, st, big,
                                      bads[-1], self.hess_vec_fn)
        else:
            fval = self.val_data if self.val_data is not None else big
            st, binfo = _adaqn_boundary(self.cfg, self.grad_fn, self.obj_fn,
                                        st, big, fval, bads[-1])
        infos = _info(bads).at[L - 1].set(binfo)
        return st, infos

    def _epoch_chunked(self, state, data, step_size, num_batches, L):
        rounds = num_batches // L
        data_r = jax.tree_util.tree_map(
            lambda a: a.reshape((rounds, L) + a.shape[1:]), data)

        unroll = self.unroll_rounds
        if unroll is None:
            unroll = rounds <= 8
        if unroll:
            infos = []
            st = state
            for r in range(rounds):
                rd = jax.tree_util.tree_map(lambda a, _r=r: a[_r], data_r)
                st, inf = self.round(st, rd, step_size)
                infos.append(inf)
            return st, jnp.concatenate(infos)

        def round_body(st, round_data):
            return self.round(st, round_data, step_size)

        state, infos = jax.lax.scan(round_body, state, data_r)
        return state, infos.reshape(num_batches)

    def _epoch_generic(self, state, data, step_size, num_batches, L):
        def body(st, i):
            batch = _batch_at(data, i)
            big = lambda: _cyclic_window(data, i, min(L, num_batches),
                                         num_batches)
            if self.optimizer == "SQN":
                st, info = sqn_step(self.cfg, self.grad_fn, st, batch, big,
                                    step_size, self.hess_vec_fn)
            else:
                fval = ((lambda: self.val_data)
                        if self.val_data is not None else big)
                st, info = adaqn_step(self.cfg, self.grad_fn, self.obj_fn,
                                      st, batch, big, fval, step_size)
            return st, info

        return jax.lax.scan(body, state, jnp.arange(num_batches),
                            unroll=self._unroll)

    def jit_epoch(self):
        """The cached jitted ``epoch``, with the state carry donated when
        ``self.donate`` (opt-in — see the field comment).  With donation
        on, use this (or ``run_epochs``) rather than
        ``jax.jit(trainer.epoch, ...)`` directly to get the in-place
        pair-memory reuse."""
        if self._epoch_jit is None:
            donate = (0,) if self.donate else ()
            object.__setattr__(
                self, "_epoch_jit",
                jax.jit(self.epoch, static_argnames=("aligned",),
                        donate_argnums=donate))
        return self._epoch_jit

    def jit_epochs(self):
        """Multi-EPOCH device program: ``fn(state, data, step_size,
        nepochs=..., aligned=...)`` runs ``nepochs`` epochs over the same
        pre-batched ``data`` inside ONE dispatch (a ``lax.scan`` over the
        epoch body).  ``step_size`` is a scalar (same step every epoch)
        or a ``[nepochs]`` array (per-epoch schedule, e.g. sqrt decay).
        Returns ``(state, infos[nepochs, B])``.

        Motivation: one host round trip per N epochs instead of per
        epoch.  A single program removes all host jitter from the timed
        window and is the right shape for synchronous callers (e.g.
        drivers that block on results each epoch, where the round trip IS exposed).
        Use when the batch schedule is epoch-invariant; per-epoch
        shuffles / step decay with a precomputable schedule belong in
        :meth:`jit_epochs_scheduled`, and schedules that need per-epoch
        host control in :meth:`run_epochs`.

        The chunked-layout ``aligned`` contract extends across epochs
        automatically when ``B % upd_freq == 0`` (niter advances by B per
        epoch).  State donation follows ``self.donate``.
        """
        if self._epochs_jit is None:
            def run(state, data, step_size, nepochs, aligned=None):
                # scalar step -> same step every epoch; a [nepochs] array
                # rides the scan as a per-epoch schedule (no gathers —
                # the cheap path for decay-without-shuffle fits)
                steps = jnp.broadcast_to(step_size, (nepochs,))

                def body(st, eta):
                    return self.epoch(st, data, eta, aligned=aligned)
                return jax.lax.scan(body, state, steps)

            donate = (0,) if self.donate else ()
            object.__setattr__(
                self, "_epochs_jit",
                jax.jit(run, static_argnames=("nepochs", "aligned"),
                        donate_argnums=donate))
        return self._epochs_jit

    def jit_epochs_scheduled(self):
        """Multi-epoch device program with a PRECOMPUTED per-epoch schedule:
        ``fn(state, flat_data, step_sizes, orders, batch_size=..., aligned=...)``.

        Unlike :meth:`jit_epochs` (same batches every epoch), this covers
        the DEFAULT guided configuration — per-epoch reshuffling and step
        decay — inside one dispatch.  Both are deterministic functions of
        the epoch index (the guided shuffle is seeded, the schedule is
        ``f(step0, epoch)``), so the host precomputes:

        - ``orders [nepochs, B*bs] int32`` — absolute row indices into
          ``flat_data`` for each epoch, in batch order (the guided
          driver's CUMULATIVE composed permutations, truncated to the
          non-ragged prefix);
        - ``step_sizes [nepochs]`` — the per-epoch step size.

        and the scan body gathers each epoch's rows on device (one
        dataset-sized gather per epoch, in place of one exposed host round
        trip per epoch for a synchronous caller).  ``flat_data`` leaves
        are UNbatched ``[n_rows, ...]``; ``batch_size`` is static.
        Returns ``(state, infos[nepochs, B])``.  State donation follows
        ``self.donate``.

        ``aligned=True`` requires every epoch to start on an update-period
        boundary (initial ``niter % upd_freq == 0`` and ``B % upd_freq
        == 0``); pass False otherwise — trajectories are identical.
        """
        if self._epochs_sched_jit is None:
            def run(state, flat_data, step_sizes, orders, batch_size,
                    aligned=None):
                if orders.shape[1] % batch_size:
                    raise ValueError(
                        f"orders.shape[1]={orders.shape[1]} must be a "
                        f"multiple of batch_size={batch_size} (each epoch "
                        "row lists exactly the gathered batch rows)")
                nbatch = orders.shape[1] // batch_size

                def body(st, xs):
                    order, eta = xs
                    d = jax.tree_util.tree_map(
                        lambda a: a[order].reshape(
                            (nbatch, batch_size) + a.shape[1:]), flat_data)
                    if self.batch_constraint is not None:
                        d = self.batch_constraint(d)
                    return self.epoch(st, d, eta, aligned=aligned)

                return jax.lax.scan(body, state, (orders, step_sizes))

            donate = (0,) if self.donate else ()
            object.__setattr__(
                self, "_epochs_sched_jit",
                jax.jit(run, static_argnames=("batch_size", "aligned"),
                        donate_argnums=donate))
        return self._epochs_sched_jit

    # -- multi-epoch driver ------------------------------------------------ #
    def run_epochs(self, state, data, nepochs, step_size,
                   decr_step_size=None, shuffle_key=None):
        """Host loop over epochs; each epoch is one fused device program.

        ``data`` leaves are pre-batched ``[B, bs, ...]``.
        ``decr_step_size(step0, epoch)`` mirrors the guided schedule hook.

        With ``donate=True`` (opt-in) the *passed-in* ``state``'s buffers
        are donated to the first epoch dispatch and become unreadable
        afterwards (the returned state is the live one) — the default
        ``donate=False`` keeps them readable at the cost of holding
        input+output copies of the pair memory across each dispatch.
        """
        epoch_fn = self.jit_epoch()
        L = getattr(self.cfg, "upd_freq", 1)
        num_batches = jax.tree_util.tree_leaves(data)[0].shape[0]
        # Resolve the chunked-layout alignment contract statically — a
        # state resumed mid-round (e.g. after a non-divisible epoch) routes
        # to the generic layout instead of silently misplacing boundaries.
        # One D2H read before the loop; niter then advances by exactly
        # num_batches per epoch, so subsequent epochs are tracked host-side
        # (reading state.niter every epoch would force a device sync per
        # dispatch and serialize the epoch pipeline).
        niter = int(state.niter)
        infos = []
        for epoch in range(nepochs):
            eta = (step_size if decr_step_size is None
                   else decr_step_size(step_size, epoch))
            d = data
            if shuffle_key is not None:
                shuffle_key, sub = jax.random.split(shuffle_key)
                d = shuffle_batched(data, sub)
            state, info = epoch_fn(state, d, eta, aligned=niter % L == 0)
            niter += num_batches
            infos.append(info)
        return state, jnp.stack(infos)


def shuffle_batched(data, key):
    """Shuffle example rows across the whole epoch, preserving batching."""
    leaves = jax.tree_util.tree_leaves(data)
    nb, bs = leaves[0].shape[:2]
    perm = jax.random.permutation(key, nb * bs)

    def shuf(a):
        flat = a.reshape((nb * bs,) + a.shape[2:])
        return flat[perm].reshape(a.shape)
    return jax.tree_util.tree_map(shuf, data)


def batchify(data, batch_size):
    """Reshape ``[n, ...]`` leaves into ``[B, batch_size, ...]``, dropping
    the ragged tail (fused mode needs static shapes)."""
    def rs(a):
        n = a.shape[0]
        nb = n // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the {n} available rows — "
                "no batches would be produced")
        return a[:nb * batch_size].reshape((nb, batch_size) + a.shape[1:])
    return jax.tree_util.tree_map(rs, data)
