"""Sparse-feature logistic losses for CTR-style workloads (padded COO).

The reference is sparse-aware end-to-end: the guided driver vstacks CSR
batches (``stochqn/_optimizers.py:81-112``) and the logistic model accepts
CSR matrices directly (``stochqn/_logistic.py:36-247``, via sklearn's
sparse-capable internals).  A CSR matrix has a *dynamic* nnz per row —
hostile to XLA's static-shape compilation model — so this design
converts once on the host to **padded COO**: every row stores exactly
``k = max_nnz`` (bucketed to a multiple) ``(index, value)`` slots, padding
with ``index 0, value 0`` which contributes nothing to any product.

Compute mapping:
  * margins  — ``gather`` of the coefficient rows at ``indices`` followed
    by a ``[B, k]`` elementwise multiply-reduce (fully fused),
  * gradients — one ``scatter-add`` of ``values * residual`` into the
    ``[n_features]`` (or ``[n_features, n_classes]``) gradient buffer;
    XLA lowers batched scatter-adds natively,
  * Hessian-vector products — a second gather of ``v`` plus the same
    scatter shape.

Everything is jit-able, differentiable, and shardable; batch leaves are
ordinary arrays so the fused engine's ``lax.scan`` epochs and the
``(data, param)`` mesh sharding apply unchanged.  For a Criteo-shaped
workload (~40 active of 1M+ hashed features) the per-step gradient cost is
O(B·k) instead of O(B·n): the two-loop's streaming passes dominate, which
is exactly the regime the bf16 pair storage and param sharding target.

Conventions match :mod:`stochqn_tpu.models.losses`: binary labels in
{-1, +1} (anything >0 maps to +1), multinomial one-hot ``Y [B, n_classes]``
with parameters ``[n_classes, n_features (+1)]`` flattened row-major, the
intercept unregularized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

try:
    from scipy.sparse import issparse
except Exception:  # pragma: no cover
    def issparse(_x):
        return False


# --------------------------------------------------------------------------
# Host-side conversion
# --------------------------------------------------------------------------
def csr_to_padded(X, max_nnz: int | None = None, pad_multiple: int = 8,
                  dtype=np.float32):
    """Convert a scipy CSR/CSC/COO matrix (or dense array) to padded COO.

    Returns ``(indices [B, k] int32, values [B, k] dtype)`` with
    ``k = ceil(max-row-nnz / pad_multiple) * pad_multiple`` (or the given
    ``max_nnz``).  Rows with more than ``max_nnz`` entries keep their
    ``max_nnz`` largest-magnitude entries.  Padding slots are
    ``(index 0, value 0)``.  Bucketing ``k`` to a multiple keeps the number
    of distinct compiled shapes small across batches.
    """
    if not issparse(X):
        X = np.asarray(X)
        nz = [np.nonzero(row)[0] for row in X]
        rows = [(idx.astype(np.int64), X[i, idx]) for i, idx in enumerate(nz)]
    else:
        X = X.tocsr()
        rows = [(X.indices[s:e].astype(np.int64), X.data[s:e])
                for s, e in zip(X.indptr[:-1], X.indptr[1:])]

    row_nnz = max((len(i) for i, _ in rows), default=0)
    if max_nnz is None:
        k = max(pad_multiple,
                ((row_nnz + pad_multiple - 1) // pad_multiple) * pad_multiple)
    else:
        k = int(max_nnz)
        if k <= 0:
            raise ValueError("'max_nnz' must be positive")

    B = len(rows)
    indices = np.zeros((B, k), np.int32)
    values = np.zeros((B, k), dtype)
    for r, (idx, val) in enumerate(rows):
        if len(idx) > k:
            keep = np.argsort(-np.abs(val))[:k]
            idx, val = idx[keep], val[keep]
        indices[r, :len(idx)] = idx
        values[r, :len(val)] = val
    return indices, values


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------
def _ensure_weights(sample_weight, n, dtype):
    if sample_weight is None:
        return jnp.ones((n,), dtype)
    return jnp.asarray(sample_weight, dtype).reshape(-1)


def _bin_split(w, n_features):
    if w.shape[0] == n_features + 1:
        return w[:n_features], w[n_features], True
    return w, jnp.zeros((), w.dtype), False


def _bin_margins(w, idx, val, n_features):
    coef, b, _ = _bin_split(w, n_features)
    rows = jnp.take(coef, idx, axis=0)               # [B, k]
    return jnp.sum(rows * val, axis=-1) + b          # [B]


def _bin_scatter_grad(t, idx, val, n_features, dtype):
    """``X^T t`` for padded-COO ``X``: scatter-add of ``val * t`` rows."""
    upd = val * t[:, None]                           # [B, k]
    return jnp.zeros((n_features,), dtype).at[idx].add(
        upd, mode="drop", unique_indices=False)


# --------------------------------------------------------------------------
# Binary logistic regression (CTR shape)
# --------------------------------------------------------------------------
def sparse_binary_logistic_loss(w, idx, val, y, n_features,
                                sample_weight=None, reg_param=0.0):
    """Equals ``losses.binary_logistic_loss(w, X_dense, y, ...)`` for the
    padded-COO form of ``X`` (parity locked by tests/test_sparse.py)."""
    dtype = w.dtype
    y = jnp.where(jnp.asarray(y).reshape(-1) > 0, 1.0, -1.0).astype(dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    z = _bin_margins(w, idx, val, n_features) * y
    loss = jnp.sum(sw * jnp.logaddexp(jnp.zeros((), dtype), -z))
    coef, _, _ = _bin_split(w, n_features)
    return loss + 0.5 * jnp.asarray(reg_param, dtype) * jnp.vdot(coef, coef)


def sparse_binary_logistic_grad(w, idx, val, y, n_features,
                                sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    y = jnp.where(jnp.asarray(y).reshape(-1) > 0, 1.0, -1.0).astype(dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    z = _bin_margins(w, idx, val, n_features)
    sig = jax.nn.sigmoid(y * z)
    t = sw * (sig - 1.0) * y                          # [B]
    coef, _, has_b = _bin_split(w, n_features)
    g_coef = _bin_scatter_grad(t, idx, val, n_features, dtype) \
        + jnp.asarray(reg_param, dtype) * coef
    if has_b:
        return jnp.concatenate([g_coef, jnp.sum(t)[None]])
    return g_coef


def sparse_binary_logistic_hessvec(w, v, idx, val, y, n_features,
                                   sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    z = _bin_margins(w, idx, val, n_features)
    sig = jax.nn.sigmoid(z)
    dd = sw * sig * (1.0 - sig)                       # [B]
    v_coef, v_b, _ = _bin_split(v, n_features)
    xv = jnp.sum(jnp.take(v_coef, idx, axis=0) * val, axis=-1) + v_b
    t = dd * xv
    _, _, has_b = _bin_split(w, n_features)
    h_coef = _bin_scatter_grad(t, idx, val, n_features, dtype) \
        + jnp.asarray(reg_param, dtype) * v_coef
    if has_b:
        return jnp.concatenate([h_coef, jnp.sum(t)[None]])
    return h_coef


def sparse_binary_logistic_predict_proba(w, idx, val, n_features):
    return jax.nn.sigmoid(_bin_margins(w, idx, val, n_features))


# --------------------------------------------------------------------------
# Multinomial logistic regression
# --------------------------------------------------------------------------
def _mult_split(w, n_features, n_classes):
    w = w.reshape(n_classes, -1)
    if w.shape[1] == n_features + 1:
        return w[:, :n_features], w[:, n_features], True
    return w, jnp.zeros((n_classes,), w.dtype), False


def _mult_logits(w, idx, val, n_features, n_classes):
    coef, b, _ = _mult_split(w, n_features, n_classes)
    rows = jnp.take(coef.T, idx, axis=0)              # [B, k, C]
    return jnp.einsum("bk,bkc->bc", val, rows,
                      preferred_element_type=w.dtype) + b[None, :]


def _mult_scatter_grad(diff, idx, val, n_features, dtype):
    """``X^T diff``: scatter-add of per-slot outer products into
    ``[n_features, n_classes]`` (returned transposed to ``[C, nf]``)."""
    upd = val[:, :, None] * diff[:, None, :]          # [B, k, C]
    g = jnp.zeros((n_features, diff.shape[1]), dtype).at[idx].add(
        upd, mode="drop", unique_indices=False)
    return g.T                                        # [C, nf]


def sparse_multinomial_logistic_loss(w, idx, val, Y, n_features,
                                     sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    n_classes = Y.shape[1]
    Y = jnp.asarray(Y, dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    logits = _mult_logits(w, idx, val, n_features, n_classes)
    logp = jax.nn.log_softmax(logits, axis=-1)
    loss = -jnp.sum(sw[:, None] * Y * logp)
    coef, _, _ = _mult_split(w, n_features, n_classes)
    return loss + 0.5 * jnp.asarray(reg_param, dtype) * jnp.vdot(coef, coef)


def sparse_multinomial_logistic_grad(w, idx, val, Y, n_features,
                                     sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    n_classes = Y.shape[1]
    Y = jnp.asarray(Y, dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    logits = _mult_logits(w, idx, val, n_features, n_classes)
    p = jax.nn.softmax(logits, axis=-1)
    diff = sw[:, None] * (p - Y)                      # [B, C]
    coef, _, has_b = _mult_split(w, n_features, n_classes)
    g_coef = _mult_scatter_grad(diff, idx, val, n_features, dtype) \
        + jnp.asarray(reg_param, dtype) * coef
    if has_b:
        g_b = jnp.sum(diff, axis=0)
        return jnp.concatenate([g_coef, g_b[:, None]], axis=1).reshape(-1)
    return g_coef.reshape(-1)


def sparse_multinomial_logistic_hessvec(w, v, idx, val, Y, n_features,
                                        sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    n_classes = Y.shape[1]
    sw = _ensure_weights(sample_weight, idx.shape[0], dtype)
    logits = _mult_logits(w, idx, val, n_features, n_classes)
    p = jax.nn.softmax(logits, axis=-1)               # [B, C]
    v_coef, _, _ = _mult_split(v, n_features, n_classes)
    zv = _mult_logits(v, idx, val, n_features, n_classes)
    inner = jnp.sum(p * zv, axis=1, keepdims=True)
    r = sw[:, None] * p * (zv - inner)                # [B, C]
    _, _, has_b = _mult_split(w, n_features, n_classes)
    h_coef = _mult_scatter_grad(r, idx, val, n_features, dtype) \
        + jnp.asarray(reg_param, dtype) * v_coef
    if has_b:
        h_b = jnp.sum(r, axis=0)
        return jnp.concatenate([h_coef, h_b[:, None]], axis=1).reshape(-1)
    return h_coef.reshape(-1)


def sparse_multinomial_logistic_predict_proba(w, idx, val, n_features,
                                              n_classes):
    """Per-class sigmoid scores (reference's prediction quirk,
    ``stochqn/_logistic.py:14-20``)."""
    return jax.nn.sigmoid(_mult_logits(w, idx, val, n_features, n_classes))
