"""L-BFGS two-loop recursion, re-derived for an accelerator.

The reference implements the classic sequential two-loop recursion
(``approx_inv_hess_grad``, ``src/stochqn.c:663-708``): for ``m`` stored
correction pairs it performs ``2m`` dependent dot products and ``m`` axpys in
the backward pass plus ``m`` more of each in the forward pass — ``~4m``
separate passes over ``O(n)`` memory, each ending in a latency-bound scalar
reduction (which would also mean ``4m`` tiny ``psum``s when ``n`` is sharded).

Here the recursion is algebraically collapsed into its *compact form*:

    backward:  alpha_c = rho_c * (s_c.g - sum_{d>c} (s_c.y_d) alpha_d)
               -> (I + diag(rho) U) alpha = rho * (S g),  U = strict-upper of S Y^T
    forward:   beta_c  = rho_c * (y_c.r0 + sum_{d<c} (y_c.s_d)(alpha_d - beta_d))
               -> (I - diag(rho) L) beta = rho * (Y r0 + L alpha),  L = strict-lower of Y S^T
    result:    d = r0 + S^T (alpha - beta),   r0 = H0 q0,   q0 = g - Y^T alpha

so the only O(n) work is three batched matmuls — ``W g``, ``W W^T`` and
``W^T u`` with ``W = [S; Y]`` of shape ``[2m, n]`` — plus an ``O(m^2)``
pair of triangular solves.  On a GPU this is 3 streaming passes over the
pair memory instead of ~4m, all matrix-shaped, and under a sharded ``n``
axis it needs exactly one fused ``psum`` of ``2m + 4m^2`` scalars instead
of ``4m`` sequential ones.  The math is exactly equivalent (associativity of the dot
products aside).

A faithful sequential variant (`two_loop_sequential`) is kept for
cross-validation: it mirrors the C loop structure operation-for-operation.

Ring-buffer handling: pairs live in storage order with ``head`` (next write
slot) and ``count``; chronological position ``c`` maps to storage row
``(start + c) % m`` with ``start = (head - count) mod m``, matching the
reference's ``(mem_st_ix + i) % mem_size`` indexing with its
``(mem_st_ix == mem_used) ? 0 : mem_st_ix`` start correction
(``src/stochqn.c:674,820``).  Instead of gathering ``[m, n]`` rows into
chronological order, only the tiny ``O(m)``/``O(m^2)`` quantities are
permuted.

Empty-memory semantics follow ``take_step`` (``src/stochqn.c:808-812``):
with no stored pairs the recursion is skipped entirely and the direction is
the raw (or diagonally rescaled) gradient — *not* ``h0 * g``.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# On the H100 a float32 matmul at default precision runs in TF32 (about
# three decimal digits); the quasi-Newton small quantities (rho, Gram,
# triangular systems) and the pair-memory products need true float32, so
# HIGHEST switches TF32 off for them.  The passes are bandwidth-, not
# FLOP-, bound.
PRECISION = jax.lax.Precision.HIGHEST


def _mem_mm(a, b, acc_t):
    """Streaming matmul against the pair/Fisher memory, storage-aware.

    float32 storage: ``Precision.HIGHEST`` (the passes are
    bandwidth-bound, so full float32 costs no time).

    bfloat16 storage: upcast *inside* the matmul and use default precision
    (on the H100 that rounds the float32 operands to TF32; accumulation
    stays ``acc_t``).  The upcast was meant to let XLA fuse the convert
    into the matvec instead of materializing a float32 copy of the
    ``[2m, n]`` buffer; on the H100 the bf16 step at n=16M is slower than
    the float32 one (PERF.md), so that fusion is in question.
    """
    if a.dtype == jnp.bfloat16 or b.dtype == jnp.bfloat16:
        return jnp.matmul(a.astype(acc_t), b.astype(acc_t),
                          preferred_element_type=acc_t)
    return jnp.matmul(a, b, preferred_element_type=acc_t,
                      precision=PRECISION)


def _chrono_perm(mem_size: int, head: jax.Array, count: jax.Array) -> jax.Array:
    """Storage row of the c-th oldest pair, for c = 0..mem_size-1."""
    start = jnp.mod(head - count, mem_size)
    return jnp.mod(start + jnp.arange(mem_size, dtype=jnp.int32), mem_size)


def two_loop(
    grad: jax.Array,
    s_mem: jax.Array,
    y_mem: jax.Array,
    head: jax.Array,
    count: jax.Array,
    *,
    h0: float = 0.0,
    diag: Optional[jax.Array] = None,
    gram: Optional[jax.Array] = None,
) -> jax.Array:
    """Approximate ``H^{-1} grad`` from the stored correction pairs.

    Args:
      grad: ``[n]`` gradient (NOT overwritten — unlike the reference).
      s_mem, y_mem: ``[m, n]`` pair ring buffers in storage order; unused rows
        must be zero (they are masked out, but zeros keep intermediates
        finite).
      head, count: ring indices (int32 scalars or Python ints).
      h0: static scalar H0 diagonal; ``<= 0`` selects the default
        ``gamma = (s.y)/(y.y)`` of the latest pair (Nocedal & Wright ch. 7,
        ``src/stochqn.c:683-689``).  Ignored when ``diag`` is given.
      diag: optional ``[n]`` elementwise H0 diagonal (adaQN,
        ``src/stochqn.c:695``).
      gram: optional cached ``[2m, 2m]`` Gram matrix ``W W^T`` in storage
        order (see :class:`stochqn_tpu.core.state.BFGSMemory`); when given,
        the per-step Gram matmul is skipped — one fewer streaming pass over
        the pair memory.

    Returns:
      ``[n]`` search direction ``d ~= H^{-1} g`` (positive direction; the
      caller steps ``x -= step_size * d``).
    """
    m, n = s_mem.shape
    dtype = grad.dtype
    acc_t = jnp.promote_types(dtype, jnp.float32)
    head = jnp.asarray(head, jnp.int32)
    count = jnp.asarray(count, jnp.int32)

    perm = _chrono_perm(m, head, count)
    cidx = jnp.arange(m, dtype=jnp.int32)
    valid = (cidx < count)
    validf = valid.astype(acc_t)

    w = jnp.concatenate([s_mem, y_mem], axis=0)                # [2m, n]
    wg = _mem_mm(w, grad, acc_t)                               # [2m]
    if gram is None:
        gram = _mem_mm(w, w.T, acc_t)
    else:
        gram = gram.astype(acc_t)

    # Chronologically ordered small quantities.
    sg = wg[:m][perm]
    yg = wg[m:][perm]
    sy = gram[:m, m:][perm][:, perm]    # sy[c, d] = s_c . y_d
    yy = gram[m:, m:][perm][:, perm]

    sy_diag = jnp.diagonal(sy)
    rho = validf / jnp.where(valid, sy_diag, jnp.ones_like(sy_diag))

    # Backward pass: unit-upper-triangular solve for alpha.
    upper = jnp.triu(rho[:, None] * sy, k=1)
    alpha = solve_triangular(
        jnp.eye(m, dtype=acc_t) + upper, rho * sg,
        lower=False, unit_diagonal=False)
    alpha = alpha * validf

    has_pairs = count > 0

    if diag is None:
        if h0 > 0:
            gamma = jnp.asarray(h0, acc_t)
        else:
            last = jnp.maximum(count - 1, 0)
            sy_last = sy_diag[last]
            yy_last = jnp.diagonal(yy)[last]
            gamma = jnp.where(
                has_pairs,
                sy_last / jnp.where(has_pairs, yy_last, jnp.ones_like(yy_last)),
                jnp.ones_like(sy_last))
        gamma = jnp.where(has_pairs, gamma, jnp.ones_like(gamma))
        # Y r0 = gamma * (Y g - Y Y^T alpha), all chronological.
        y_r0 = gamma * (yg - jnp.matmul(yy, alpha, preferred_element_type=acc_t,
                    precision=PRECISION))
    else:
        yd = y_mem.astype(acc_t) * diag[None, :].astype(acc_t)
        yd_g_st = _mem_mm(yd, grad, acc_t)
        ydy_st = _mem_mm(yd, y_mem.T, acc_t)
        yd_g = yd_g_st.astype(acc_t)[perm]
        ydy = ydy_st.astype(acc_t)[perm][:, perm]
        y_r0 = yd_g - jnp.matmul(ydy, alpha, preferred_element_type=acc_t,
                    precision=PRECISION)

    # Forward pass: unit-lower-triangular solve for beta.
    ys = sy.T                                   # ys[c, d] = y_c . s_d
    lower = jnp.tril(rho[:, None] * ys, k=-1)
    rhs = rho * y_r0 + jnp.matmul(lower, alpha, preferred_element_type=acc_t,
                    precision=PRECISION)
    beta = solve_triangular(
        jnp.eye(m, dtype=acc_t) + lower, rhs,
        lower=True, unit_diagonal=False)
    beta = beta * validf

    # Scatter chronological coefficients back to storage order and expand.
    inv_perm_coeff_s = jnp.zeros((m,), acc_t).at[perm].set(alpha - beta)
    inv_perm_alpha = jnp.zeros((m,), acc_t).at[perm].set(alpha)

    st_alpha_y = _mem_mm(inv_perm_alpha, y_mem, acc_t)
    st_coeff_s = _mem_mm(inv_perm_coeff_s, s_mem, acc_t)

    g_acc = grad.astype(acc_t)
    if diag is None:
        d = gamma * (g_acc - st_alpha_y) + st_coeff_s
    else:
        d = diag.astype(acc_t) * (g_acc - st_alpha_y) + st_coeff_s

    # Empty memory -> raw gradient (or diag-rescaled gradient for adaQN).
    if diag is None:
        empty = g_acc
    else:
        empty = diag.astype(acc_t) * g_acc
    return jnp.where(has_pairs, d, empty).astype(dtype)


def two_loop_cached(
    grad: jax.Array,
    mem,
    *,
    h0: float = 0.0,
    diag: Optional[jax.Array] = None,
    collapsed: bool = False,
    coupling: str = "matvec",
) -> jax.Array:
    """Two-loop using the commit-time small-math cache in ``BFGSMemory``.

    Identical math to :func:`two_loop`, but all gradient-independent
    O(m)/O(m^2) quantities (permutation, rho, inverted triangular systems,
    chronological Y Y^T, forward coupling, gamma) come precomputed from
    ``stochqn_tpu.ops.pairs.commit_pair``.  A step is then:

        project  ``W g``                    (one [2m, n] pass)
        small    three m-sized matvecs      (alpha, y_r0, beta)
        expand   ``gamma g + W^T u``        (one [2m, n] pass)

    which minimizes the per-step op count — inside a ``lax.scan`` every
    small sequential op is one more kernel launch.  This is the production
    path used by the state machines and the fused engine.

    ``coupling`` selects the diagonal-H0 (adaQN) coupling formulation:

      * ``"matvec"`` (default) — ``Y @ (D (g - Y^T alpha))``: pure
        matvecs, no ``[m, n]`` intermediate, the fewest bytes on one
        device.
      * ``"gram"`` — the ``(Y*D) g`` / ``(Y*D) Y^T`` products: more HBM
        traffic, but every n-contraction is available simultaneously, so
        a param-sharded ``n`` axis needs ONE fused psum per step where
        the matvec form chains two dependent ones — prefer it when the
        psum latency dominates (large meshes, small per-device n).
    """
    if coupling not in ("matvec", "gram"):
        raise ValueError(f"coupling must be 'matvec' or 'gram', "
                         f"got {coupling!r}")
    # BFGSMemoryInterleaved stores one [2m, n] buffer whose rows are W in
    # INTERLEAVED order [s_0, y_0, s_1, y_1, ...] — and so are its cached
    # c0/cg — handled by the layout branches below.  Duck-typed on the
    # field to avoid an ops -> core import cycle.
    interleaved = hasattr(mem, "sy")
    if interleaved:
        if diag is not None:
            raise ValueError(
                "pairs_interleaved does not support a diagonal H0 (adaQN) "
                "— see core.state.BFGSMemoryInterleaved")
        m = mem.sy.shape[0] // 2
        w_int = mem.sy
        s_mem = y_mem = None
    else:
        s_mem, y_mem = mem.s, mem.y
        m = s_mem.shape[0]
        w_int = None
    dtype = grad.dtype
    acc_t = mem.bwd_inv.dtype
    perm = mem.perm
    count = mem.count
    has_pairs = count > 0

    if collapsed and diag is None:
        # Collapsed form: the entire gamma-scaled two-loop is
        #   d = gamma*g + W^T ((c0 + gamma*cg) @ (W g)),  W = [s; y]
        # with (c0, cg) precomputed at commit time
        # (pairs._small_cache(direction_cache=True)).  Two [2m, n] passes
        # plus TWO tiny matvecs — the fewest sequential ops per step inside
        # lax.scan.  Requires callers
        # to have committed with direction_cache=True.
        if h0 > 0:
            gamma = jnp.asarray(h0, acc_t)
        else:
            gamma = mem.gamma
        gamma = jnp.where(has_pairs, gamma, jnp.ones_like(gamma))
        c = mem.c0 + gamma * mem.cg
        # c0/cg were cached by commit_pair in the memory's own row order,
        # so both layouts run the identical three-op chain here.
        w = w_int if interleaved else jnp.concatenate([s_mem, y_mem], axis=0)
        wg = _mem_mm(w, grad, acc_t)
        u = jnp.matmul(c, wg.astype(acc_t), preferred_element_type=acc_t,
                       precision=PRECISION)
        g_acc = grad.astype(acc_t)
        d = gamma * g_acc + _mem_mm(u, w, acc_t)
        # count==0 also covers post-flush staleness of (c0, cg): flush only
        # resets the scalar indices, so the select below is what masks the
        # stale collapsed cache (mirrors the classic path's `empty` select).
        return jnp.where(has_pairs, d, g_acc).astype(dtype)

    w = w_int if interleaved else jnp.concatenate([s_mem, y_mem], axis=0)
    wg = _mem_mm(w, grad, acc_t)

    if interleaved:
        sg = wg[0::2][perm]
        yg = wg[1::2][perm]
    else:
        sg = wg[:m][perm]
        yg = wg[m:][perm]

    alpha = jnp.matmul(mem.bwd_inv, mem.rho * sg,
                       preferred_element_type=acc_t,
                    precision=PRECISION)

    g_acc = grad.astype(acc_t)
    u2 = None
    if diag is None:
        if h0 > 0:
            gamma = jnp.asarray(h0, acc_t)
        else:
            gamma = mem.gamma
        gamma = jnp.where(has_pairs, gamma, jnp.ones_like(gamma))
        y_r0 = gamma * (yg - jnp.matmul(mem.yy_c, alpha,
                                        preferred_element_type=acc_t,
                    precision=PRECISION))
    elif coupling == "gram":
        # both n-contractions are independent of alpha, so under a
        # sharded n axis they ride one fused psum
        yd = y_mem.astype(acc_t) * diag[None, :].astype(acc_t)
        ydg_st = _mem_mm(yd, grad, acc_t)
        ydy_st = _mem_mm(yd, y_mem.T, acc_t)
        ydg = ydg_st.astype(acc_t)[perm]
        ydy = ydy_st.astype(acc_t)[perm][:, perm]
        y_r0 = ydg - jnp.matmul(ydy, alpha, preferred_element_type=acc_t,
                    precision=PRECISION)
    else:
        # Matvec form of the diagonal-H0 coupling:
        #   YD g - YD Y^T alpha = Y @ (D * (g - Y^T alpha))
        # — no [m, n] ``Y*D`` intermediate and no [m, m] weighted Gram per
        # step; ``Y^T alpha`` is reused as the expansion's alpha term and
        # ``D*(g - Y^T alpha)`` as the direction's diagonal term below.
        diag_acc = diag.astype(acc_t)
        alpha_st = jnp.zeros((m,), acc_t).at[perm].set(alpha)
        st_alpha_y = _mem_mm(alpha_st, y_mem, acc_t)          # [n]
        u2 = diag_acc * (g_acc - st_alpha_y)                  # [n]
        y_r0 = _mem_mm(y_mem, u2, acc_t)[perm]                # [m]

    rhs = mem.rho * y_r0 + jnp.matmul(mem.rl_c, alpha,
                                      preferred_element_type=acc_t,
                    precision=PRECISION)
    beta = jnp.matmul(mem.fwd_inv, rhs, preferred_element_type=acc_t,
                    precision=PRECISION)

    if interleaved:
        # Single [2m, n] expansion pass:  d = gamma g + u @ W  with
        #   u[2i]   = (alpha - beta) scattered to storage order  (S rows)
        #   u[2i+1] = -gamma * alpha scattered                   (Y rows)
        # (invalid chronological slots carry exact zeros — rho masking).
        u = (jnp.zeros((2 * m,), acc_t)
             .at[2 * perm].set(alpha - beta)
             .at[2 * perm + 1].set(-gamma * alpha))
        d = gamma * g_acc + _mem_mm(u, w, acc_t)
        return jnp.where(has_pairs, d, g_acc).astype(dtype)

    coeff_s = jnp.zeros((m,), acc_t).at[perm].set(alpha - beta)
    st_coeff_s = _mem_mm(coeff_s, s_mem, acc_t)

    if diag is None:
        alpha_st = jnp.zeros((m,), acc_t).at[perm].set(alpha)
        st_alpha_y = _mem_mm(alpha_st, y_mem, acc_t)
        d = gamma * (g_acc - st_alpha_y) + st_coeff_s
        empty = g_acc
    elif u2 is not None:
        d = u2 + st_coeff_s          # u2 == D * (g - Y^T alpha)
        empty = diag.astype(acc_t) * g_acc
    else:
        alpha_st = jnp.zeros((m,), acc_t).at[perm].set(alpha)
        st_alpha_y = _mem_mm(alpha_st, y_mem, acc_t)
        d = diag.astype(acc_t) * (g_acc - st_alpha_y) + st_coeff_s
        empty = diag.astype(acc_t) * g_acc
    return jnp.where(has_pairs, d, empty).astype(dtype)


def two_loop_sequential(
    grad: jax.Array,
    s_mem: jax.Array,
    y_mem: jax.Array,
    head: jax.Array,
    count: jax.Array,
    *,
    h0: float = 0.0,
    diag: Optional[jax.Array] = None,
) -> jax.Array:
    """Operation-faithful sequential two-loop (mirrors ``src/stochqn.c:663-708``).

    Used for oracle cross-checks and as a clarity reference; ``two_loop`` is
    the production path.
    """
    m, n = s_mem.shape
    dtype = grad.dtype
    head = jnp.asarray(head, jnp.int32)
    count = jnp.asarray(count, jnp.int32)
    start = jnp.mod(head - count, m)

    def row(mem, c):
        return jax.lax.dynamic_index_in_dim(
            mem, jnp.mod(start + c, m), axis=0, keepdims=False)

    def bwd_body(ii, carry):
        q, alpha, rho = carry
        c = count - ii - 1
        s_c, y_c = row(s_mem, c), row(y_mem, c)
        rho_c = 1.0 / jnp.vdot(y_c, s_c)
        alpha_c = rho_c * jnp.vdot(q, s_c)
        q = q - alpha_c * y_c
        return q, alpha.at[c].set(alpha_c), rho.at[c].set(rho_c)

    q0, alpha, rho = jax.lax.fori_loop(
        0, count, bwd_body,
        (grad, jnp.zeros((m,), dtype), jnp.zeros((m,), dtype)))

    if diag is not None:
        r = diag * q0
    elif h0 > 0:
        r = jnp.asarray(h0, dtype) * q0
    else:
        last = jnp.mod(start + jnp.maximum(count - 1, 0), m)
        s_l = jax.lax.dynamic_index_in_dim(s_mem, last, 0, keepdims=False)
        y_l = jax.lax.dynamic_index_in_dim(y_mem, last, 0, keepdims=False)
        denom = jnp.vdot(y_l, y_l)
        gamma = jnp.where(count > 0,
                          jnp.vdot(s_l, y_l) / jnp.where(denom != 0, denom, 1.0),
                          jnp.ones((), dtype))
        r = gamma * q0

    def fwd_body(c, r):
        s_c, y_c = row(s_mem, c), row(y_mem, c)
        beta = rho[c] * jnp.vdot(y_c, r)
        return r + (alpha[c] - beta) * s_c

    d = jax.lax.fori_loop(0, count, fwd_body, r)
    return jnp.where(count > 0, d, grad if diag is None else diag * grad)
