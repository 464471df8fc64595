"""Closed-form logistic losses, gradients and Hessian-vector products in JAX.

The reference delegates these to scikit-learn private internals
(``stochqn/_logistic.py:3-34``: ``_logistic_loss_and_grad``,
``_logistic_grad_hess``, ``_multinomial_loss_grad``,
``_multinomial_grad_hess``).  Here they are first-class JAX functions —
jit-able, differentiable, shardable — with the same conventions:

  * binary: labels in {-1, +1} (anything >0 maps to +1), parameter vector
    ``[n_features (+ 1 intercept)]``, loss
    ``sum_i w_i log(1 + exp(-y_i z_i)) + 0.5 reg ||coef||^2`` (intercept
    unregularized).
  * multinomial: one-hot ``Y [n, k]``, parameters ``[k, n_features (+1)]``
    flattened row-major, loss ``-sum_i w_i sum_c Y log softmax(z)_c
    + 0.5 reg ||coef||^2``.

Hessian-vector products use closed forms (same math as sklearn's), but a
generic ``hvp_from_grad`` built on forward-over-reverse ``jax.jvp`` is also
provided and is what the fused engine uses for arbitrary losses.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def hvp_from_grad(grad_fun: Callable) -> Callable:
    """Hessian-vector product via forward-over-reverse differentiation.

    ``grad_fun(x, *args) -> [n]``; returns ``hvp(x, v, *args) -> [n]``.
    Replaces the reference's requirement that the user hand-code
    ``hess_vec_fun`` (``stochqn/_optimizers.py:544-550``).
    """
    def hvp(x, v, *args):
        return jax.jvp(lambda xx: grad_fun(xx, *args), (x,), (v,))[1]
    return hvp


# --------------------------------------------------------------------------
# Binary logistic regression
# --------------------------------------------------------------------------
def _split_bin(w, n_features):
    has_intercept = w.shape[0] == n_features + 1
    if has_intercept:
        return w[:n_features], w[n_features]
    return w, jnp.zeros((), w.dtype)


def _bin_margins(w, X):
    coef, b = _split_bin(w, X.shape[1])
    return jnp.matmul(X, coef, preferred_element_type=w.dtype) + b


def _ensure_weights(sample_weight, n, dtype):
    if sample_weight is None:
        return jnp.ones((n,), dtype)
    return jnp.asarray(sample_weight, dtype).reshape(-1)


def binary_logistic_loss(w, X, y, sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    y = jnp.where(jnp.asarray(y).reshape(-1) > 0, 1.0, -1.0).astype(dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    z = _bin_margins(w, X) * y
    # log(1 + exp(-z)), stable
    loss = jnp.sum(sw * jnp.logaddexp(jnp.zeros((), dtype), -z))
    coef, _ = _split_bin(w, X.shape[1])
    return loss + 0.5 * jnp.asarray(reg_param, dtype) * jnp.vdot(coef, coef)


def binary_logistic_grad(w, X, y, sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    y = jnp.where(jnp.asarray(y).reshape(-1) > 0, 1.0, -1.0).astype(dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    z = _bin_margins(w, X)
    sig = jax.nn.sigmoid(y * z)
    t = sw * (sig - 1.0) * y                      # [n]
    coef, _ = _split_bin(w, X.shape[1])
    g_coef = jnp.matmul(t, X, preferred_element_type=dtype) \
        + jnp.asarray(reg_param, dtype) * coef
    if w.shape[0] == X.shape[1] + 1:
        return jnp.concatenate([g_coef, jnp.sum(t)[None]])
    return g_coef


def binary_logistic_hessvec(w, v, X, y, sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    z = _bin_margins(w, X)
    sig = jax.nn.sigmoid(z)
    dd = sw * sig * (1.0 - sig)                   # [n]
    nf = X.shape[1]
    v_coef, v_b = _split_bin(v, nf)
    xv = jnp.matmul(X, v_coef, preferred_element_type=dtype) + v_b
    t = dd * xv
    h_coef = jnp.matmul(t, X, preferred_element_type=dtype) \
        + jnp.asarray(reg_param, dtype) * v_coef
    if w.shape[0] == nf + 1:
        return jnp.concatenate([h_coef, jnp.sum(t)[None]])
    return h_coef


def binary_logistic_predict_proba(w, X):
    return jax.nn.sigmoid(_bin_margins(w, X))


# --------------------------------------------------------------------------
# Multinomial logistic regression
# --------------------------------------------------------------------------
def _split_mult(w, n_features, n_classes):
    w = w.reshape(n_classes, -1)
    has_intercept = w.shape[1] == n_features + 1
    if has_intercept:
        return w[:, :n_features], w[:, n_features]
    return w, jnp.zeros((n_classes,), w.dtype)


def _mult_logits(w, X, n_classes):
    coef, b = _split_mult(w, X.shape[1], n_classes)
    return jnp.matmul(X, coef.T, preferred_element_type=w.dtype) + b[None, :]


def multinomial_logistic_loss(w, X, Y, sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    n_classes = Y.shape[1]
    Y = jnp.asarray(Y, dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    logits = _mult_logits(w, X, n_classes)
    logp = jax.nn.log_softmax(logits, axis=-1)
    loss = -jnp.sum(sw[:, None] * Y * logp)
    coef, _ = _split_mult(w, X.shape[1], n_classes)
    return loss + 0.5 * jnp.asarray(reg_param, dtype) * jnp.vdot(coef, coef)


def multinomial_logistic_grad(w, X, Y, sample_weight=None, reg_param=0.0):
    dtype = w.dtype
    n_classes = Y.shape[1]
    Y = jnp.asarray(Y, dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    logits = _mult_logits(w, X, n_classes)
    p = jax.nn.softmax(logits, axis=-1)
    diff = sw[:, None] * (p - Y)                   # [n, k]
    coef, _ = _split_mult(w, X.shape[1], n_classes)
    g_coef = jnp.matmul(diff.T, X, preferred_element_type=dtype) \
        + jnp.asarray(reg_param, dtype) * coef     # [k, nf]
    if w.shape[0] == n_classes * (X.shape[1] + 1):
        g_b = jnp.sum(diff, axis=0)                # [k]
        return jnp.concatenate([g_coef, g_b[:, None]], axis=1).reshape(-1)
    return g_coef.reshape(-1)


def multinomial_logistic_hessvec(w, v, X, Y, sample_weight=None, reg_param=0.0):
    """Closed-form multinomial Gauss/true Hessian-vector product (the
    multinomial Hessian equals its GGN); same math as sklearn's
    ``_multinomial_grad_hess``."""
    dtype = w.dtype
    n_classes = Y.shape[1]
    sw = _ensure_weights(sample_weight, X.shape[0], dtype)
    nf = X.shape[1]
    has_intercept = w.shape[0] == n_classes * (nf + 1)

    logits = _mult_logits(w, X, n_classes)
    p = jax.nn.softmax(logits, axis=-1)            # [n, k]

    v_coef, v_b = _split_mult(v, nf, n_classes)
    zv = jnp.matmul(X, v_coef.T, preferred_element_type=dtype) + v_b[None, :]
    # r = p * zv - p * (sum_c p_c zv_c)
    inner = jnp.sum(p * zv, axis=1, keepdims=True)
    r = sw[:, None] * p * (zv - inner)             # [n, k]
    h_coef = jnp.matmul(r.T, X, preferred_element_type=dtype) \
        + jnp.asarray(reg_param, dtype) * v_coef
    if has_intercept:
        h_b = jnp.sum(r, axis=0)
        return jnp.concatenate([h_coef, h_b[:, None]], axis=1).reshape(-1)
    return h_coef.reshape(-1)


def multinomial_logistic_predict_proba(w, X, n_classes):
    """Per-class sigmoid scores, matching the reference's prediction function
    (``stochqn/_logistic.py:14-20`` applies an elementwise sigmoid to the
    margins rather than a softmax)."""
    return jax.nn.sigmoid(_mult_logits(w, X, n_classes))


def multinomial_logistic_predict_softmax(w, X, n_classes):
    """Proper softmax class probabilities (an extension)."""
    return jax.nn.softmax(_mult_logits(w, X, n_classes), axis=-1)
