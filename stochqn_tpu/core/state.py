"""Optimizer state pytrees.

The reference keeps optimizer state in C structs of raw pointers mirrored by
language-side "holder" objects (``stochqn/_optimizers.py:791-879``,
``include/stochqn.h:86-151``).  Here the whole state is a single immutable JAX
pytree: device-resident, trivially checkpointable (``.npz`` of numpy
leaves), shardable along the parameter axis, and usable as a ``lax.scan``
carry.  The C coroutine's ``section`` resume-point field becomes an int32 leaf
driving a ``lax.switch``.

Unlike the reference there are no ``s_bak`` / ``y_bak`` backup buffers
(``src/stochqn.c:589-604``): rejected correction pairs are simply never
committed, which also sidesteps a latent reference bug where
``backup_corr_pair`` copies in the wrong direction and a rejected pair can
corrupt the oldest stored pair when the ring is full.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from stochqn_tpu.core.pytree import dataclass, static_field


def _own(x0) -> jax.Array:
    """A buffer the state owns exclusively.

    ``jnp.asarray`` aliases an input that is already a JAX array; the fused
    engine donates the state carry into its epoch dispatch
    (``FusedTrainer.jit_epoch``), and donating a buffer the caller still
    holds would invalidate their array (and donating one buffer reachable
    through two state leaves is an XLA error).  A one-time copy at init
    removes both hazards.
    """
    x0 = jnp.asarray(x0)
    return jnp.array(x0, copy=True)


@dataclass
class BFGSMemory:
    """Ring buffer of (s, y) correction pairs, chronological via head/count.

    Mirrors ``bfgs_mem`` (``include/stochqn.h:86-99``) minus the backup
    buffers; ``head`` is the next write slot (C ``mem_st_ix``), ``count`` the
    number of live pairs (C ``mem_used``).  The earliest live pair sits at
    ``(head - count) mod mem_size``.

    ``s_pending`` holds the candidate ``s`` vector between the moment it is
    computed and the moment the matching ``y`` arrives and the pair passes the
    curvature test.  The reference writes the candidate straight into the ring
    slot (``src/stochqn.c:861-870,1005-1007``); keeping it separate makes
    accept/reject a pure functional choice.

    ``gram`` caches ``W W^T`` for ``W = [s; y]`` (``[2m, 2m]``, storage
    order), maintained incrementally on every accepted pair (one
    ``[2m, n] @ [n, 2]`` matmul per insert).  This removes the per-step Gram
    recomputation from the compact two-loop, bringing it to the minimum two
    streaming passes over the pair memory per step (project ``W g`` +
    expand ``W^T u``).  Entries touching dead/stale rows are garbage but are
    fully masked by ``count`` inside the two-loop.

    Beyond the Gram, the *entire* small (O(m)/O(m^2)) algebra of the
    two-loop that is independent of the incoming gradient is precomputed at
    commit time and carried in the state: the chronological permutation,
    rho, the inverted backward/forward triangular systems, the
    chronological ``Y Y^T`` block, the forward coupling matrix, and the
    default gamma.  A two-loop step then reduces to the two ``[2m, n]``
    streaming passes plus a handful of ``m``-sized matvecs — important
    inside ``lax.scan`` where per-op overhead, not FLOPs, dominates.
    """

    s: jax.Array          # [mem_size, n]
    y: jax.Array          # [mem_size, n]
    gram: jax.Array       # [2*mem_size, 2*mem_size] cached W W^T
    s_pending: jax.Array  # [n]
    head: jax.Array       # int32 scalar: next slot to write
    count: jax.Array      # int32 scalar: number of live pairs
    # --- commit-time small-math cache (chronological order) ---
    perm: jax.Array       # [mem_size] int32: chrono -> storage row
    rho: jax.Array        # [mem_size] 1/(s.y), masked to 0 when invalid
    bwd_inv: jax.Array    # [m, m] (I + diag(rho) triu(SY,1))^{-1}
    fwd_inv: jax.Array    # [m, m] (I + diag(rho) tril(YS,-1))^{-1}
    yy_c: jax.Array       # [m, m] chronological Y Y^T
    rl_c: jax.Array       # [m, m] diag(rho) tril(YS,-1)
    gamma: jax.Array      # scalar: default H0 = (s.y)/(y.y) of latest pair
    # --- optional collapsed-direction cache (see pairs._small_cache):
    # the whole gamma-scaled two-loop collapses to
    #   d = gamma*g + W^T ((c0 + gamma*cg) @ (W g)),  W = [s; y]
    # letting a single fused kernel read W from HBM once per step.
    # Zeros unless commit_pair(direction_cache=True).
    c0: jax.Array         # [2m, 2m]
    cg: jax.Array         # [2m, 2m]

    @classmethod
    def create(cls, mem_size: int, n: int, dtype=jnp.float32,
               storage_dtype=None) -> "BFGSMemory":
        gram_t = jnp.promote_types(dtype, jnp.float32)
        m = mem_size
        st_t = dtype if storage_dtype is None else storage_dtype
        return cls(
            s=jnp.zeros((m, n), dtype=st_t),
            y=jnp.zeros((m, n), dtype=st_t),
            gram=jnp.zeros((2 * m, 2 * m), dtype=gram_t),
            s_pending=jnp.zeros((n,), dtype=dtype),
            head=jnp.zeros((), dtype=jnp.int32),
            count=jnp.zeros((), dtype=jnp.int32),
            perm=jnp.arange(m, dtype=jnp.int32),
            rho=jnp.zeros((m,), dtype=gram_t),
            bwd_inv=jnp.eye(m, dtype=gram_t),
            fwd_inv=jnp.eye(m, dtype=gram_t),
            yy_c=jnp.zeros((m, m), dtype=gram_t),
            rl_c=jnp.zeros((m, m), dtype=gram_t),
            gamma=jnp.ones((), dtype=gram_t),
            c0=jnp.zeros((2 * m, 2 * m), dtype=gram_t),
            cg=jnp.zeros((2 * m, 2 * m), dtype=gram_t),
        )

    @property
    def mem_size(self) -> int:
        return self.s.shape[0]

    def flush(self) -> "BFGSMemory":
        """Logically empty the memory (data stays, indices reset) —
        ``flush_bfgs_mem``, ``src/stochqn.c:554-558``."""
        zero = jnp.zeros((), dtype=jnp.int32)
        return self.replace(head=zero, count=zero)


@dataclass
class BFGSMemoryInterleaved:
    """:class:`BFGSMemory` with the pair rows stored interleaved, as a
    SHIFT buffer (newest pair first) rather than a rotating ring.

    ``sy[2i] = s`` / ``sy[2i + 1] = y`` of the i-th NEWEST pair — one
    ``[2m, n]`` buffer.  A commit rebuilds it in one fused sequential
    pass (``[new slab; sy[:-2]]``, vetoed by a scalar select on reject);
    ``head`` is kept for API symmetry but is always 0 — chronology is
    positional.  Motivation: oLBFGS commits a pair EVERY iteration, and
    a dynamic-update-slice into a ``lax.scan`` carry can make XLA copy
    the whole buffer before writing; the rewrite pays one sequential pass
    instead.  The shift rewrite won on the earlier accelerator (PERF.md);
    it has not been measured on the H100.

    ``shift`` (static, decided at :meth:`create`): the shift rewrite
    holds input AND output buffers live across the commit, so its PEAK
    footprint is 2x the pair memory — fine at streaming scale, fatal at
    the capacity ceiling.  Buffers larger than :data:`SHIFT_MAX_BYTES`
    fall back to the DUS ring (rotating ``head``, in-place at the donated
    program boundary), whose peak is 1x.  Chronology handling follows the
    mode (``ops/pairs``).

    Why ``[2m, n]`` flat and not ``[m, 2, n]``: the two-loop then needs
    no reshape at all — the buffer IS ``W`` (in interleaved row order) —
    and every streaming pass reads long contiguous rows.

    The ``gram`` cache and the collapsed-direction matrices ``c0``/``cg``
    are kept in INTERLEAVED index order (rows ``[s_0, y_0, s_1, y_1,
    ...]``); the chronological small-math cache (``perm``/``rho``/
    triangular inverses/...) is layout-independent.  Same API surface as
    :class:`BFGSMemory` (``s``/``y`` become strided views); selected via
    ``pairs_interleaved=True`` on the oLBFGS/SQN configs.  Not supported
    for adaQN (its diagonal-H0 coupling reads ``y`` rows separately per
    step, which would force strided gathers; adaQN commits only at
    boundaries, so the write saving is negligible there anyway).
    """

    sy: jax.Array         # [2 * mem_size, n]: rows [s_0, y_0, s_1, y_1, ...]
    gram: jax.Array       # [2m, 2m] cached W W^T, INTERLEAVED order
    s_pending: jax.Array  # [n]
    head: jax.Array       # int32
    count: jax.Array      # int32
    perm: jax.Array       # chronological small-math cache — see BFGSMemory
    rho: jax.Array
    bwd_inv: jax.Array
    fwd_inv: jax.Array
    yy_c: jax.Array
    rl_c: jax.Array
    gamma: jax.Array
    c0: jax.Array         # [2m, 2m], INTERLEAVED order
    cg: jax.Array         # [2m, 2m], INTERLEAVED order
    # static commit mode: True = shift rewrite (fast), False = DUS ring
    # (capacity) — see the class docstring
    shift: bool = static_field(default=True)

    @classmethod
    def create(cls, mem_size: int, n: int, dtype=jnp.float32,
               storage_dtype=None, shift=None) -> "BFGSMemoryInterleaved":
        base = BFGSMemory.create(mem_size, n, dtype, storage_dtype)
        kw = {f: getattr(base, f) for f in
              ("gram", "s_pending", "head", "count", "perm", "rho",
               "bwd_inv", "fwd_inv", "yy_c", "rl_c", "gamma", "c0", "cg")}
        sy = jnp.zeros((2 * mem_size, n), dtype=base.s.dtype)
        if shift is None:
            shift = sy.size * sy.dtype.itemsize <= SHIFT_MAX_BYTES
        return cls(sy=sy, shift=bool(shift), **kw)

    @property
    def mem_size(self) -> int:
        return self.sy.shape[0] // 2

    @property
    def s(self) -> jax.Array:
        """Storage-order s rows (a strided view — NOT for hot loops)."""
        return self.sy[0::2]

    @property
    def y(self) -> jax.Array:
        return self.sy[1::2]

    def flush(self) -> "BFGSMemoryInterleaved":
        zero = jnp.zeros((), dtype=jnp.int32)
        return self.replace(head=zero, count=zero)


# Above this pair-buffer size the interleaved layout commits via the DUS
# ring instead of the shift rewrite: the shift's transient peak is 2x the
# buffer.  The value was chosen for the 16 GB earlier accelerator
# (PERF.md) and has not been measured on the H100's 80 GB.
SHIFT_MAX_BYTES = 4 * 1024 ** 3


def make_bfgs_memory(mem_size: int, n: int, dtype=jnp.float32,
                     storage_dtype=None, interleaved: bool = False):
    cls = BFGSMemoryInterleaved if interleaved else BFGSMemory
    return cls.create(mem_size, n, dtype, storage_dtype)


@dataclass
class FisherMemory:
    """Ring buffer of recent minibatch gradients for adaQN's empirical Fisher.

    Mirrors ``fisher_mem`` (``include/stochqn.h:101-107``).  Rows are only
    ever consumed through the symmetric product ``F^T (F s) / count`` so
    chronological order is irrelevant; only occupancy matters.

    ``shift`` (static, auto-decided at :meth:`create`): for SMALL buffers
    the per-step append is a shift rewrite (``[g; f[:-1]]``, newest row
    first) instead of a dynamic-update-slice into the ring slot — the
    same economics as the oLBFGS shift pair buffer: a DUS into a
    ``lax.scan`` carry costs a near-constant mutated-carry price while
    the rewrite pays bytes, so the rewrite wins exactly when
    ``2 * fs * n * itemsize`` is cheap — hence the
    :data:`FISHER_SHIFT_MAX_BYTES` bound (the reference default fs=100
    stays on the DUS ring; ``benchmarks/fisher_append_ab.py`` compares
    the two).  Occupancy semantics are identical (valid
    rows are always ``[0, count)`` while filling, everything once full);
    only the storage order differs, which ``F^T (F s)`` sums over — a
    float reduction-order delta of the same class the engines already
    carry.
    """

    f: jax.Array      # [fisher_size, n]
    head: jax.Array   # int32
    count: jax.Array  # int32
    # static append mode: True = shift rewrite (small buffers), False =
    # DUS ring — see the class docstring
    shift: bool = static_field(default=False)

    @classmethod
    def create(cls, fisher_size: int, n: int, dtype=jnp.float32,
               storage_dtype=None, shift=None) -> "FisherMemory":
        f = jnp.zeros((fisher_size, n),
                      dtype=dtype if storage_dtype is None else storage_dtype)
        if shift is None:
            shift = f.size * f.dtype.itemsize <= FISHER_SHIFT_MAX_BYTES
        return cls(
            f=f,
            head=jnp.zeros((), dtype=jnp.int32),
            count=jnp.zeros((), dtype=jnp.int32),
            shift=bool(shift),
        )

    def flush(self) -> "FisherMemory":
        zero = jnp.zeros((), dtype=jnp.int32)
        return self.replace(head=zero, count=zero)

    def append(self, grad: jax.Array) -> "FisherMemory":
        """``add_to_fisher_mem`` (``src/stochqn.c:581-587``)."""
        size = self.f.shape[0]
        if self.shift:
            f = jnp.concatenate(
                [grad.astype(self.f.dtype)[None], self.f[:-1]], axis=0)
        else:
            f = jax.lax.dynamic_update_index_in_dim(
                self.f, grad.astype(self.f.dtype), self.head, axis=0)
        return self.replace(
            f=f,
            head=(self.head + 1) % size,   # kept for API symmetry in shift
            count=jnp.minimum(self.count + 1, size),
        )

    def append_block(self, grads: jax.Array) -> "FisherMemory":
        """Append ``grads [k, n]`` in order — identical to ``k`` successive
        :meth:`append` calls, as one scatter (or one shifted rebuild in
        shift mode).

        Block-ingestion API (e.g. replaying recorded gradients into a
        resumed state).  The fused engine does NOT use it: the
        deferred-append round layout was slower than the per-step ring
        write on the earlier accelerator (PERF.md).
        """
        size = self.f.shape[0]
        k = grads.shape[0]
        keep = min(k, size)          # only the last `size` rows can survive
        rows = grads[k - keep:].astype(self.f.dtype)
        if self.shift:
            # k successive shift-appends leave the last `keep` grads
            # newest-first at the top, the old rows shifted down
            f = jnp.concatenate([rows[::-1], self.f[:size - keep]], axis=0)
        else:
            slots = jnp.mod(self.head + (k - keep)
                            + jnp.arange(keep, dtype=jnp.int32), size)
            f = self.f.at[slots].set(rows)
        return self.replace(
            f=f,
            head=jnp.mod(self.head + k, size).astype(jnp.int32),
            count=jnp.minimum(self.count + k, size).astype(jnp.int32),
        )


# Above this Fisher-buffer size the per-step append stays a DUS ring
# write: the shift rewrite pays 2 x buffer bytes per step.  The break-even
# was chosen on the earlier accelerator (PERF.md) and has not been
# measured on the H100.
FISHER_SHIFT_MAX_BYTES = 8 * 1024 ** 2


@dataclass
class OLBFGSState:
    """Full oLBFGS optimizer state (``workspace_oLBFGS``,
    ``include/stochqn.h:109-120``)."""

    x: jax.Array          # [n] current iterate
    mem: BFGSMemory
    grad_prev: jax.Array  # [n]
    niter: jax.Array      # int32
    section: jax.Array    # int32 coroutine resume point (0, 1, 2)

    @classmethod
    def create(cls, x0: jax.Array, mem_size: int,
               pairs_bf16: bool = False,
               pairs_interleaved: bool = False) -> "OLBFGSState":
        x0 = _own(x0)
        n = x0.shape[0]
        st_t = jnp.bfloat16 if pairs_bf16 else None
        return cls(
            x=x0,
            mem=make_bfgs_memory(mem_size, n, x0.dtype, st_t,
                                 interleaved=pairs_interleaved),
            grad_prev=jnp.zeros((n,), dtype=x0.dtype),
            niter=jnp.zeros((), dtype=jnp.int32),
            section=jnp.zeros((), dtype=jnp.int32),
        )


@dataclass
class SQNState:
    """Full SQN optimizer state (``workspace_SQN``,
    ``include/stochqn.h:122-133``).

    ``x_sum`` doubles as ``x_avg`` after division — the reference aliases the
    two with a macro (``src/stochqn.c:134``); we keep the single-array
    semantics so trajectories match exactly.
    """

    x: jax.Array
    mem: BFGSMemory
    grad_prev: jax.Array   # [n] big-batch gradient at previous average
    x_sum: jax.Array       # [n] sum (or, post-division, average) of iterates
    x_avg_prev: jax.Array  # [n]
    niter: jax.Array       # int32
    section: jax.Array     # int32 (0..4)

    @classmethod
    def create(cls, x0: jax.Array, mem_size: int,
               pairs_bf16: bool = False,
               pairs_interleaved: bool = False) -> "SQNState":
        x0 = _own(x0)
        n = x0.shape[0]
        st_t = jnp.bfloat16 if pairs_bf16 else None
        # one jnp.zeros per field: a single shared buffer reachable through
        # several leaves would be donated twice (XLA error) — see _own
        return cls(
            x=x0,
            mem=make_bfgs_memory(mem_size, n, x0.dtype, st_t,
                                 interleaved=pairs_interleaved),
            grad_prev=jnp.zeros((n,), dtype=x0.dtype),
            x_sum=jnp.zeros((n,), dtype=x0.dtype),
            x_avg_prev=jnp.zeros((n,), dtype=x0.dtype),
            niter=jnp.zeros((), dtype=jnp.int32),
            section=jnp.zeros((), dtype=jnp.int32),
        )


@dataclass
class AdaQNState:
    """Full adaQN optimizer state (``workspace_adaQN``,
    ``include/stochqn.h:135-151``)."""

    x: jax.Array
    mem: BFGSMemory
    fisher: FisherMemory   # size 0 rows when use_grad_diff
    grad_prev: jax.Array   # [n] (used only when use_grad_diff)
    x_sum: jax.Array
    x_avg_prev: jax.Array
    grad_sum_sq: jax.Array  # [n] AdaGrad / RMSProp accumulator
    f_prev: jax.Array       # scalar: accepted function value at prev average
    niter: jax.Array        # int32
    section: jax.Array      # int32 (0..5)

    @classmethod
    def create(cls, x0: jax.Array, mem_size: int, fisher_size: int,
               pairs_bf16: bool = False,
               fisher_bf16: bool = False) -> "AdaQNState":
        x0 = _own(x0)
        n = x0.shape[0]
        st_t = jnp.bfloat16 if pairs_bf16 else None
        f_t = jnp.bfloat16 if fisher_bf16 else None
        # one jnp.zeros per field (donation-safe — see _own / SQNState)
        return cls(
            x=x0,
            mem=BFGSMemory.create(mem_size, n, x0.dtype, st_t),
            fisher=FisherMemory.create(max(fisher_size, 1), n, x0.dtype, f_t),
            grad_prev=jnp.zeros((n,), dtype=x0.dtype),
            x_sum=jnp.zeros((n,), dtype=x0.dtype),
            x_avg_prev=jnp.zeros((n,), dtype=x0.dtype),
            grad_sum_sq=jnp.zeros((n,), dtype=x0.dtype),
            f_prev=jnp.zeros((), dtype=x0.dtype),
            niter=jnp.zeros((), dtype=jnp.int32),
            section=jnp.zeros((), dtype=jnp.int32),
        )
