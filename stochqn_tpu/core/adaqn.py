"""adaQN transition function (Keskar & Berahas, 2016).

Pure-functional re-design of ``run_adaQN`` (``src/stochqn.c:1155-1315``).

Protocol (identical to the reference):

    section 0 -> request ``calc_grad`` at x                            -> 1
    section 1 -> append grad to Fisher memory; AdaGrad/RMSProp-
                 preconditioned L-BFGS step; ``x_sum += x``;
                 every L iterations:
                   first time: archive averages, then (grad-diff)
                     request big-batch grad at x_avg_prev              -> 2
                     or (max_incr) function value at x_avg_prev        -> 3
                   later: (max_incr) request f at x_avg                -> 5
                     else build s and either request big-batch grad    -> 4
                     or commit the Fisher-product pair inline          -> 1
    section 2 -> store grad_prev; (max_incr) request f at x_avg_prev   -> 3
    section 3 -> store f_prev                                          -> 1
    section 4 -> ``y = g_big - grad_prev``; commit pair                -> 1
    section 5 -> accept/reject on ``f > max_incr * f_prev``:
                   reject: flush BFGS + Fisher memory, revert x to
                     x_avg_prev (``func_increased``)                   -> 1
                   accept: build s; Fisher pair or big-batch request   -> 1/4

Reference quirks reproduced deliberately (trajectory parity):
  * H0 diagonal: see ``AdaQNConfig.h0_exact_reference``.
  * On a rejected (NaN) direction only the BFGS memory is flushed — the
    Fisher flush is commented out in the reference (``src/stochqn.c:1181``).
  * ``x_sum`` is *not* reset on a ``func_increased`` rejection
    (``src/stochqn.c:1275-1283``), so the next window's average folds in the
    rejected window's average once.
  * With ``use_grad_diff`` the reference never refreshes ``x_avg_prev``
    after the first archive (section 4, ``src/stochqn.c:1265-1270``) —
    unlike both the Fisher path and SQN.  Reproduced as-is; the Fisher path
    is the default and unaffected.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stochqn_tpu.core.config import AdaQNConfig
from stochqn_tpu.core.enums import Info, Task
from stochqn_tpu.core.protocol import AdvanceResult, result, select
from stochqn_tpu.core.state import AdaQNState
from stochqn_tpu.ops.accumulators import diag_rescal
from stochqn_tpu.ops.pairs import commit_pair, direction_is_bad, fisher_y
from stochqn_tpu.ops.two_loop import two_loop_cached


def init(x0: jax.Array, cfg: AdaQNConfig) -> AdaQNState:
    return AdaQNState.create(x0, cfg.mem_size, cfg.fisher_size,
                             pairs_bf16=cfg.pairs_bf16,
                             fisher_bf16=cfg.fisher_bf16)


def _resume(st: AdaQNState, info, x_changed) -> Tuple[AdaQNState, AdvanceResult]:
    return (st.replace(section=jnp.int32(1)),
            result(Task.CALC_GRAD, info, x_changed))


def _commit_fisher_pair(cfg: AdaQNConfig, st: AdaQNState, info, changed,
                        x_avg: jax.Array) -> Tuple[AdaQNState, AdvanceResult]:
    """``update_y`` label, Fisher branch (``src/stochqn.c:1297-1308``)."""
    y_cand = fisher_y(st.fisher, st.mem.s_pending)
    mem, accepted = commit_pair(st.mem, y_cand, cfg.min_curvature, y_reg=0.0)
    st = st.replace(
        mem=mem,
        x_avg_prev=jnp.where(accepted, x_avg, st.x_avg_prev),
        x_sum=jnp.zeros_like(st.x_sum),
    )
    new_info = jnp.where(
        accepted, info,
        jnp.int32(Info.CURVATURE_TOO_SMALL))
    return _resume(st, new_info, changed)


def advance(cfg: AdaQNConfig, state: AdaQNState, grad: jax.Array,
            f: jax.Array, step_size: jax.Array
            ) -> Tuple[AdaQNState, AdvanceResult]:
    step_size = jnp.asarray(step_size, state.x.dtype)
    f = jnp.asarray(f, state.x.dtype)
    L = cfg.upd_freq
    inv_l = jnp.asarray(1.0 / L, state.x.dtype)
    no_prob = jnp.int32(Info.NO_PROBLEMS_ENCOUNTERED)

    def sec0(st: AdaQNState):
        return _resume(st, no_prob, False)

    def sec1(st: AdaQNState):
        if not cfg.use_grad_diff:
            st = st.replace(fisher=st.fisher.append(grad))

        # take_step with diagonal preconditioning (src/stochqn.c:1177-1178).
        rescaled, acc = diag_rescal(grad, st.grad_sum_sq, cfg.scal_reg,
                                    cfg.rmsprop_weight)
        if cfg.h0_exact_reference:
            h0_diag = rescaled
        else:
            h0_diag = jax.lax.rsqrt(acc + jnp.asarray(cfg.scal_reg, acc.dtype))
        d_mem = two_loop_cached(grad, st.mem, diag=h0_diag,
                                coupling=cfg.coupling)
        d = jnp.where(st.mem.count > 0, d_mem, rescaled)

        if cfg.check_nan:
            bad = direction_is_bad(d)
        else:
            bad = jnp.zeros((), bool)

        new_x = jnp.where(bad, st.x, st.x - step_size * d)
        mem = select(bad, st.mem.flush(), st.mem)  # Fisher NOT flushed
        info = jnp.where(bad, jnp.int32(Info.SEARCH_DIRECTION_WAS_NAN), no_prob)
        changed = jnp.logical_not(bad)

        niter = st.niter + 1
        st = st.replace(x=new_x, mem=mem, grad_sum_sq=acc, niter=niter,
                        x_sum=st.x_sum + new_x)

        def update_time(st: AdaQNState):
            x_avg = st.x_sum * inv_l

            def first(st: AdaQNState):
                st = st.replace(x_avg_prev=x_avg,
                                x_sum=jnp.zeros_like(st.x_sum))
                if cfg.use_grad_diff:
                    return (st.replace(section=jnp.int32(2)),
                            result(Task.CALC_GRAD_BIG_BATCH, info, changed))
                if cfg.max_incr > 0:
                    return (st.replace(section=jnp.int32(3)),
                            result(Task.CALC_FUN_VAL_BATCH, info, changed))
                return _resume(st, info, changed)

            def later(st: AdaQNState):
                if cfg.max_incr > 0:
                    # Evaluate f on the new averages first
                    # (src/stochqn.c:1227-1234).
                    st = st.replace(x_sum=x_avg, section=jnp.int32(5))
                    return st, result(Task.CALC_FUN_VAL_BATCH, info, changed)
                s_cand = x_avg - st.x_avg_prev
                st = st.replace(x_sum=x_avg,
                                mem=st.mem.replace(s_pending=s_cand))
                if cfg.use_grad_diff:
                    return (st.replace(section=jnp.int32(4)),
                            result(Task.CALC_GRAD_BIG_BATCH, info, changed))
                return _commit_fisher_pair(cfg, st, info, changed, x_avg)

            return jax.lax.cond(niter == L, first, later, st)

        return jax.lax.cond(jnp.mod(niter, L) == 0,
                            update_time,
                            lambda st: _resume(st, info, changed),
                            st)

    def sec2(st: AdaQNState):
        st = st.replace(grad_prev=grad)
        if cfg.max_incr > 0:
            return (st.replace(section=jnp.int32(3)),
                    result(Task.CALC_FUN_VAL_BATCH, no_prob, False))
        return _resume(st, no_prob, False)

    def sec3(st: AdaQNState):
        return _resume(st.replace(f_prev=f), no_prob, False)

    def sec4(st: AdaQNState):
        y_cand = grad - st.grad_prev
        mem, accepted = commit_pair(st.mem, y_cand, cfg.min_curvature,
                                    cfg.y_reg)
        st = st.replace(
            mem=mem,
            grad_prev=jnp.where(accepted, grad, st.grad_prev),
            x_sum=jnp.zeros_like(st.x_sum),
        )
        info = jnp.where(accepted, no_prob, jnp.int32(Info.CURVATURE_TOO_SMALL))
        return _resume(st, info, False)

    def sec5(st: AdaQNState):
        # x_sum currently holds x_avg (divided in section 1).
        x_avg = st.x_sum
        reject = ((f > jnp.asarray(cfg.max_incr, f.dtype) * st.f_prev)
                  | jnp.logical_not(jnp.isfinite(f)))

        def rejected(st: AdaQNState):
            st = st.replace(
                mem=st.mem.flush(),
                fisher=st.fisher.flush(),
                x=st.x_avg_prev,
            )
            # Note: x_sum deliberately not reset (reference quirk).
            return _resume(st, jnp.int32(Info.FUNC_INCREASED), True)

        def accepted_path(st: AdaQNState):
            s_cand = x_avg - st.x_avg_prev
            st = st.replace(f_prev=f,
                            mem=st.mem.replace(s_pending=s_cand))
            if cfg.use_grad_diff:
                return (st.replace(section=jnp.int32(4)),
                        result(Task.CALC_GRAD_BIG_BATCH, no_prob, False))
            return _commit_fisher_pair(cfg, st, no_prob, False, x_avg)

        return jax.lax.cond(reject, rejected, accepted_path, st)

    return jax.lax.switch(state.section,
                          [sec0, sec1, sec2, sec3, sec4, sec5], state)
