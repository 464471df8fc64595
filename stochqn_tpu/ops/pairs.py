"""Correction-pair construction, validity checks, and ring-buffer commits.

Functional equivalents of ``take_step``'s NaN/magnitude guard
(``src/stochqn.c:825-835``), ``update_s_vector`` / ``check_min_curvature``
(``src/stochqn.c:861-900``) and the ``update_y_*`` family
(``src/stochqn.c:915-966``).  Rollback is free here: a rejected pair is simply
never written, so no backup buffers exist (see note in
:mod:`stochqn_tpu.core.state`).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stochqn_tpu.core.state import (BFGSMemory, BFGSMemoryInterleaved,
                                    FisherMemory)
from stochqn_tpu.ops.two_loop import PRECISION, _chrono_perm, _mem_mm


# Two [2m]-row orderings of W are in play (selected by the memory class):
#   block order       b: rows [s_0..s_{m-1}, y_0..y_{m-1}]   (BFGSMemory)
#   interleaved order k: rows [s_0, y_0, s_1, y_1, ...]      (BFGSMemoryInterleaved)
# All layout-dependent [2m]-indexed quantities (gram, wg, c0, cg) follow the
# memory's ordering; conversion needs only static strided slices
# (gram_int[0::2, 1::2] is the s.y block, etc.), never a gather.


def _gram_cols(buf, row_s, row_y, acc_t):
    """The incremental-Gram pass ``buf @ [row_s; row_y]^T`` as TWO
    ``[.., n] @ [n]`` matvecs stacked small, NOT one ``[n, 2]`` matmul.

    The two-matvec form won on the earlier accelerator (PERF.md), where a
    2-column operand got a narrow memory tile; it has not been measured
    on the H100 (``benchmarks/gram_pass_ab.py`` and
    ``benchmarks/olbfgs_gram_ab.py`` compare the two)."""
    return jnp.stack([_mem_mm(buf, row_s, acc_t),
                      _mem_mm(buf, row_y, acc_t)], axis=1)


def direction_is_bad(direction: jax.Array) -> jax.Array:
    """Reference guard: non-finite direction, or ``||d||_2 > 1e3 * n``
    (``src/stochqn.c:827-829``).

    Implemented as ONE ``[n]`` reduction instead of an ``isfinite``-all
    plus a norm: any NaN/Inf entry makes the norm NaN/Inf, and both fail
    ``norm <= threshold`` — so ``not (norm <= t)`` is exactly
    ``(not finite) or (norm > t)``.  This runs in every engine's per-step
    hot path, where op count is the cost driver.
    """
    n = direction.shape[0]
    acc_t = jnp.promote_types(direction.dtype, jnp.float32)
    norm = jnp.linalg.norm(direction.astype(acc_t))
    return jnp.logical_not(norm <= jnp.asarray(1e3 * n, acc_t))


def conditional_flush(mem: BFGSMemory, pred: jax.Array) -> BFGSMemory:
    """Flush the ring iff ``pred`` — touching only the scalar indices.

    A naive ``tree_map(where(pred, flushed, mem))`` would materialize an
    elementwise select over the whole ``[m, n]`` pair buffers (tens of MB
    of traffic per step); flushing is purely an index reset
    (``src/stochqn.c:554-558``), so only ``head``/``count`` change.
    """
    zero = jnp.zeros((), jnp.int32)
    return mem.replace(head=jnp.where(pred, zero, mem.head),
                       count=jnp.where(pred, zero, mem.count))


def commit_pair(mem: BFGSMemory, y_cand: jax.Array, min_curvature: float,
                y_reg: float, enabled=None,
                direction_cache: bool = False
                ) -> Tuple[BFGSMemory, jax.Array]:
    """Try to commit ``(mem.s_pending, y_cand [+ y_reg * s])`` into the ring.

    Implements ``update_y_grad_diff``-style regularization plus
    ``check_min_curvature`` (``src/stochqn.c:883-926``): accept iff
    ``s.y / s.s > min_curvature`` (always accept when ``min_curvature <= 0``).
    ``enabled`` (optional bool scalar) vetoes the commit entirely (used by
    the fused engine to skip pair creation after a rejected direction).

    Returns ``(new_mem, accepted)``; on rejection the memory is unchanged.

    Written copy-free: rejection writes the *current* row contents back into
    the touched row and recomputes its (identical, deterministic) Gram
    entries, so no full-buffer select ever materializes.

    Edge-case deviation from the C code: a 0/0 curvature ratio (``s == 0``)
    produces NaN, which the C comparison ``curv <= min_curvature`` treats as
    an accept; here NaN rejects (the safer choice).
    """
    s = mem.s_pending
    if y_reg > 0:
        y_cand = y_cand + jnp.asarray(y_reg, y_cand.dtype) * s

    if min_curvature > 0:
        acc_t = jnp.promote_types(s.dtype, jnp.float32)
        sy = jnp.vdot(s.astype(acc_t), y_cand.astype(acc_t))
        ss = jnp.vdot(s.astype(acc_t), s.astype(acc_t))
        curv = sy / ss
        accepted = curv > jnp.asarray(min_curvature, acc_t)
    else:
        accepted = jnp.ones((), dtype=bool)
    if enabled is not None:
        accepted = accepted & enabled

    size = mem.mem_size
    interleaved = isinstance(mem, BFGSMemoryInterleaved)
    gram_t = mem.gram.dtype
    # Row to write: the candidate on accept, the existing contents on
    # reject (an idempotent rewrite — O(n), not O(m n)).
    if interleaved and not mem.shift:
        # Capacity-mode commit (static fallback above
        # ``state.SHIFT_MAX_BYTES``): the rotating ring with a
        # single contiguous [2, n] dynamic-update-slice.  Slower in a
        # scan carry (XLA copies the buffer first) but its peak footprint
        # is 1x the pair memory where the shift rewrite needs 2x — the
        # branch for pair memories near the card's capacity.
        st_t = mem.sy.dtype
        cur = jax.lax.dynamic_slice_in_dim(mem.sy, 2 * mem.head, 2,
                                           axis=0)              # [2, n]
        row_s = jnp.where(accepted, s.astype(st_t), cur[0])
        row_y = jnp.where(accepted, y_cand.astype(st_t), cur[1])
        new_sy = jax.lax.dynamic_update_slice_in_dim(
            mem.sy, jnp.stack([row_s, row_y]), 2 * mem.head, axis=0)
        p = _gram_cols(new_sy, row_s, row_y, gram_t)           # [2m, 2]
        zero = jnp.zeros((), mem.head.dtype)
        gram = jax.lax.dynamic_update_slice(
            mem.gram, p.astype(gram_t), (zero, 2 * mem.head))
        gram = jax.lax.dynamic_update_slice(
            gram, p.T.astype(gram_t), (2 * mem.head, zero))
        buf_updates = dict(sy=new_sy)
    elif interleaved:
        st_t = mem.sy.dtype  # may be a narrower storage dtype (pairs_bf16)
        # SHIFT ring: the newest pair lives at rows 0-1 and a
        # commit REBUILDS the buffer as one fused sequential pass
        # (select(accepted, [slab; sy[:-2]], sy)) instead of a
        # dynamic-update-slice into the ring slot.  Rationale: a DUS into
        # a ``lax.scan`` carry makes XLA copy the whole [2m, n] buffer
        # before writing the slab (``benchmarks/olbfgs_op_budget.py
        # --bf16-interleaved`` compares slab_only and slab_shift), and
        # oLBFGS pays a commit EVERY iteration.  ``head`` stays 0:
        # chronology is positional (newest first — see
        # ``_small_cache``'s interleaved perm).
        slab = jnp.stack([s.astype(st_t), y_cand.astype(st_t)])
        shifted = jnp.concatenate([slab, mem.sy[:-2]], axis=0)
        new_sy = jnp.where(accepted, shifted, mem.sy)
        p = _gram_cols(new_sy, slab[0], slab[1], gram_t)       # [2m, 2]
        # Gram shifts with the rows: old block moves down-right by 2, the
        # new pair's row/column come from one pass over the new buffer.
        # All O(m^2) — the [2m, n] traffic above is what matters.
        g_shift = jnp.zeros_like(mem.gram)
        g_shift = g_shift.at[2:, 2:].set(mem.gram[:-2, :-2])
        g_shift = g_shift.at[:, 0:2].set(p.astype(gram_t))
        g_shift = g_shift.at[0:2, :].set(p.T.astype(gram_t))
        gram = jnp.where(accepted, g_shift, mem.gram)
        buf_updates = dict(sy=new_sy)
    else:
        st_t = mem.s.dtype
        cur_s = jax.lax.dynamic_index_in_dim(mem.s, mem.head, 0,
                                             keepdims=False)
        cur_y = jax.lax.dynamic_index_in_dim(mem.y, mem.head, 0,
                                             keepdims=False)
        row_s = jnp.where(accepted, s.astype(st_t), cur_s)
        row_y = jnp.where(accepted, y_cand.astype(st_t), cur_y)
        new_s = jax.lax.dynamic_update_index_in_dim(mem.s, row_s, mem.head,
                                                    axis=0)
        new_y = jax.lax.dynamic_update_index_in_dim(mem.y, row_y, mem.head,
                                                    axis=0)

        # Incremental Gram update: one pass over [2m, n] refreshes the
        # row and column of W W^T touched by the written pair.  On reject
        # this recomputes the existing entries bit-identically.
        w_new = jnp.concatenate([new_s, new_y], axis=0)          # [2m, n]
        p = _gram_cols(w_new, row_s, row_y, gram_t)              # [2m, 2]
        gram = mem.gram
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 0].astype(gram_t), mem.head, axis=1)
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 1].astype(gram_t), size + mem.head, axis=1)
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 0].astype(gram_t), mem.head, axis=0)
        gram = jax.lax.dynamic_update_index_in_dim(
            gram, p[:, 1].astype(gram_t), size + mem.head, axis=0)
        buf_updates = dict(s=new_s, y=new_y)

    if interleaved and mem.shift:
        new_head = mem.head            # shift layout: head is always 0
    else:
        new_head = jnp.where(accepted, (mem.head + 1) % size, mem.head)
    new_count = jnp.where(accepted, jnp.minimum(mem.count + 1, size),
                          mem.count)
    cache = _small_cache(gram, new_head, new_count, size,
                         direction_cache=direction_cache,
                         interleaved=interleaved,
                         shift=interleaved and mem.shift)

    new_mem = mem.replace(
        gram=gram,
        head=new_head,
        count=new_count,
        **buf_updates,
        **cache,
    )
    return new_mem, accepted


def _small_cache(gram: jax.Array, head: jax.Array, count: jax.Array,
                 mem_size: int, direction_cache: bool = False,
                 interleaved: bool = False, shift: bool = False) -> dict:
    """Commit-time precomputation of everything in the two-loop that does
    not depend on the incoming gradient: chronological permutation, rho,
    the inverted backward/forward triangular systems, the chronological
    ``Y Y^T`` block, the forward coupling matrix, and default gamma.

    Amortized over ``upd_freq`` steps, this turns the per-step small math
    into three ``m``-sized matvecs (see ``two_loop``'s cached fast path).

    ``interleaved`` says the incoming ``gram`` (and the produced ``c0``/
    ``cg``) use the interleaved [2m] row order; the chronological outputs
    (perm/rho/inverses/yy_c/rl_c/gamma) are layout-independent.
    """
    m = mem_size
    acc_t = gram.dtype
    cidx = jnp.arange(m, dtype=jnp.int32)
    if shift:
        # shift layout: the newest pair is storage slot 0, so the c-th
        # OLDEST of `count` live pairs sits at slot count-1-c (invalid
        # c values land on arbitrary in-range slots, masked downstream
        # via rho/validf like the ring layout's stale slots)
        perm = jnp.mod(count - 1 - cidx, m)
    else:
        perm = _chrono_perm(m, head, count)
    valid = cidx < count
    validf = valid.astype(acc_t)

    if interleaved:
        sy = gram[0::2, 1::2][perm][:, perm]
        yy = gram[1::2, 1::2][perm][:, perm]
    else:
        sy = gram[:m, m:][perm][:, perm]
        yy = gram[m:, m:][perm][:, perm]
    sy_diag = jnp.diagonal(sy)
    rho = validf / jnp.where(valid, sy_diag, jnp.ones_like(sy_diag))

    eye = jnp.eye(m, dtype=acc_t)
    ru = jnp.triu(rho[:, None] * sy, k=1)
    rl = jnp.tril(rho[:, None] * sy.T, k=-1)
    # (I + N)^{-1} for strictly-triangular (nilpotent, N^m = 0) N via the
    # log-depth Neumann factorization (I - N)(I + N^2)(I + N^4)... —
    # exact once the exponents cover m, like the m-1-step Horner chain
    # (X <- I - N X) but with a critical path of ~2*ceil(log2 m) - 1
    # dependent matmuls instead of m-1 (the squarings overlap the product
    # chain).  Sequential op count is what commits cost (oLBFGS commits
    # every iteration); unrolled small matmuls beat XLA's sequential
    # triangular-solve loop inside a scan either way, and both systems
    # ride ONE batched [2, m, m] chain (same latency as [m, m]).
    n_stack = jnp.stack([ru, rl])                       # [2, m, m]

    def mm2(x, y):
        return jnp.matmul(x, y, preferred_element_type=acc_t,
                          precision=PRECISION)

    inv = eye - n_stack
    sq, k = n_stack, 2
    while k < m:
        sq = mm2(sq, sq)
        inv = mm2(inv, eye + sq)
        k *= 2
    bwd_inv, fwd_inv = inv[0], inv[1]

    has_pairs = count > 0
    last = jnp.maximum(count - 1, 0)
    yy_last = jnp.diagonal(yy)[last]
    gamma = jnp.where(
        has_pairs,
        sy_diag[last] / jnp.where(has_pairs, yy_last, jnp.ones_like(yy_last)),
        jnp.ones((), acc_t))

    yy_m = yy * validf[:, None] * validf[None, :]
    out = dict(perm=perm, rho=rho, bwd_inv=bwd_inv, fwd_inv=fwd_inv,
               yy_c=yy_m, rl_c=rl, gamma=gamma)

    if not direction_cache:
        out["c0"] = jnp.zeros((2 * m, 2 * m), acc_t)
        out["cg"] = jnp.zeros((2 * m, 2 * m), acc_t)
        return out

    # Collapse the whole gamma-scaled two-loop into u = C @ (W g):
    #   alpha = Binv Drho P wgs                   (A1 = Binv Drho P)
    #   y_r0  = gamma (P wgy - YY A1 wgs)
    #   beta  = Finv (Drho y_r0 + RL A1 wgs)
    #   u_s   = P^T (alpha - beta),   u_y = -gamma P^T alpha
    #   d     = gamma g + u_s @ S + u_y @ Y
    # Everything is linear in wg and affine in gamma, so
    # C = c0 + gamma * cg with both matrices commit-time constants.
    # (gamma may be overridden per step by a scalar hess_init — that is why
    # the affine split is kept rather than baking the cached gamma in.)
    def mm(a, b):
        return jnp.matmul(a, b, preferred_element_type=acc_t,
                          precision=PRECISION)

    p_mat = jax.nn.one_hot(perm, m, dtype=acc_t)          # (P x)_i = x[perm_i]
    drho_p = rho[:, None] * p_mat
    a1 = mm(bwd_inv, drho_p)
    finv_rl_a1 = mm(fwd_inv, mm(rl, a1))
    c0_ss = mm(p_mat.T, a1 - finv_rl_a1)
    cg_ss = mm(p_mat.T, mm(fwd_inv, rho[:, None] * mm(yy_m, a1)))
    cg_sy = -mm(p_mat.T, mm(fwd_inv, drho_p))
    cg_ys = -mm(p_mat.T, a1)

    if interleaved:
        # Same blocks scattered to the interleaved row order via static
        # strided writes (C_int[2i, 2j] = C_blk[i, j], etc. — no gather).
        z2m = jnp.zeros((2 * m, 2 * m), acc_t)
        out["c0"] = z2m.at[0::2, 0::2].set(c0_ss)
        out["cg"] = (z2m.at[0::2, 0::2].set(cg_ss)
                     .at[0::2, 1::2].set(cg_sy)
                     .at[1::2, 0::2].set(cg_ys))
        return out

    zero_m = jnp.zeros((m, m), acc_t)
    out["c0"] = jnp.block([[c0_ss, zero_m], [zero_m, zero_m]])
    out["cg"] = jnp.block([[cg_ss, cg_sy], [cg_ys, zero_m]])
    return out


def fisher_y(fisher: FisherMemory, s: jax.Array) -> jax.Array:
    """Empirical-Fisher y vector: ``y = F^T (F s) / count``
    (``update_y_fisher``, ``src/stochqn.c:936-952``).

    Two ``[k, n]`` matvecs; under a sharded ``n`` axis the inner ``F s``
    product is one ``psum`` of a length-``k`` vector.
    """
    acc_t = jnp.promote_types(s.dtype, jnp.float32)
    fs = _mem_mm(fisher.f, s, acc_t)                              # [k]
    k = jnp.arange(fisher.f.shape[0], dtype=jnp.int32)
    fs = jnp.where(k < fisher.count, fs, jnp.zeros_like(fs))
    y = _mem_mm(fs, fisher.f, acc_t)                              # [n]
    denom = jnp.maximum(fisher.count, 1).astype(acc_t)
    return (y / denom).astype(s.dtype)
