"""Stochastic logistic regression fit with the quasi-Newton optimizers.

Scikit-learn-style model equivalent to the reference's
``StochasticLogisticRegression`` (``stochqn/_logistic.py:36-247``), with the
loss / gradient / Hessian-vector functions implemented natively in JAX
(:mod:`stochqn_tpu.models.losses`) instead of borrowed from sklearn
internals.

Conventions preserved:
  * binary vs. multinomial auto-detected from ``y.ndim``
    (``stochqn/_logistic.py:164-177``); multinomial expects one-hot labels,
  * sample weights normalized to sum to one (``stochqn/_logistic.py:159``),
  * initial weights ``~ Normal(0, 1)`` with ``np.random.seed(random_state)``
    (``stochqn/_logistic.py:178-179``),
  * ``partial_fit`` holds the step size constant unless asked otherwise
    (``stochqn/_logistic.py:239-245``).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

try:
    from scipy.sparse import issparse
except Exception:  # pragma: no cover
    def issparse(_x):
        return False

from stochqn_tpu.guided import SQN, adaQN, oLBFGS, step_size_const
from stochqn_tpu.models import losses
from stochqn_tpu.models import sparse as sparse_losses


def _densify(X):
    return np.asarray(X.todense()) if issparse(X) else np.asarray(X)


def _padded(X, dtype, max_nnz=None):
    """Host CSR -> padded-COO jnp arrays (see models/sparse.py).

    Memoized on the matrix object: one protocol boundary presents the same
    stored big batch to the gradient, function-value, and Hessian-vector
    evaluators back to back, and the conversion is a host-side Python loop
    over rows — converting once per batch object instead of once per call.

    ``max_nnz`` pins the padded width ``k``; ``fit`` derives it from the
    FULL matrix so every batch compiles to the same ``[B, k]`` shape
    (otherwise each distinct per-batch max-nnz bucket is a recompile).
    A pinned width never truncates: a batch denser than ``max_nnz`` (e.g.
    partial_fit data after an earlier fit) falls back to its own width —
    csr_to_padded would otherwise silently drop features.
    """
    if max_nnz is not None:
        Xr = X.tocsr() if hasattr(X, "tocsr") else X
        indptr = getattr(Xr, "indptr", None)
        if indptr is not None and len(indptr) > 1:
            batch_max = int(np.diff(indptr).max())
            if batch_max > max_nnz:
                max_nnz = None          # exactness over shape stability
    key = (np.dtype(dtype).str, max_nnz)
    cached = getattr(X, "_stochqn_padded", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    idx, val = sparse_losses.csr_to_padded(X, max_nnz=max_nnz,
                                           dtype=np.dtype(dtype))
    out = (jnp.asarray(idx), jnp.asarray(val))
    try:
        X._stochqn_padded = (key, out)
    except AttributeError:  # immutable container; just skip the memo
        pass
    return out


class StochasticLogisticRegression:
    """Logistic regression (binary or multinomial) trained with oLBFGS, SQN,
    or adaQN.

    Parameters mirror the reference (``stochqn/_logistic.py:40-56``):
    ``reg_param`` is l2 strength on an *average* log-loss (sample weights are
    normalized), ``optimizer`` is one of ``"oLBFGS" | "SQN" | "adaQN"``, and
    extra ``optimizer_kwargs`` flow to the underlying guided optimizer.
    ``dtype`` (an extension) selects the compute dtype; default float32.
    """

    def __init__(self, reg_param=1e-3, fit_intercept=True, random_state=1,
                 optimizer="SQN", step_size=1e-1, valset_frac=0.1,
                 verbose=False, dtype=jnp.float32, engine="protocol",
                 mesh=None, **optimizer_kwargs):
        if optimizer not in ("oLBFGS", "SQN", "adaQN"):
            raise ValueError("'optimizer' must be one of 'oLBFGS', 'SQN', "
                             "'adaQN'")
        if engine not in ("protocol", "fused"):
            raise ValueError("'engine' must be 'protocol' or 'fused'")
        if mesh is not None and engine != "fused":
            raise ValueError("'mesh' requires engine='fused'")
        self.engine = engine
        self.mesh = mesh
        if step_size <= 0:
            raise ValueError("'step_size' must be positive")
        if reg_param < 0:
            raise ValueError("'reg_param' must be non-negative")
        optimizer_kwargs["step_size"] = float(step_size)
        optimizer_kwargs["valset_frac"] = valset_frac
        optimizer_kwargs["verbose"] = verbose
        optimizer_kwargs.setdefault("dtype", dtype)

        self.optimizer_name = optimizer
        self.optimizer = None
        self.optimizer_kwargs = optimizer_kwargs
        self.reg_param = float(reg_param)
        self.fit_intercept = bool(fit_intercept)
        self.random_state = random_state
        self.nclasses: Optional[int] = None
        self._is_mult: Optional[bool] = None
        self.is_fitted = False
        self._x_fused: Optional[np.ndarray] = None
        # padded-COO width pinned by fit() from the full matrix; None =
        # derive per batch (partial_fit streaming, where no full matrix
        # exists)
        self._pad_k: Optional[int] = None

    # ------------------------------------------------------------------ #
    @property
    def x_(self):
        """Flat parameter vector, regardless of training engine."""
        if self._x_fused is not None:
            return self._x_fused
        return None if self.optimizer is None else self.optimizer.x

    @property
    def coef_(self):
        if not self.is_fitted:
            return None
        x = self.x_
        if self._is_mult:
            w = x.reshape(self.nclasses, -1)
            return w[:, :-1] if self.fit_intercept else w
        return x[:-1] if self.fit_intercept else x

    @property
    def intercept_(self):
        if not self.is_fitted:
            return None
        x = self.x_
        if self._is_mult:
            if self.fit_intercept:
                return x.reshape(self.nclasses, -1)[:, -1]
            return np.zeros(self.nclasses)
        return x[-1] if self.fit_intercept else 0.0

    # ------------------------------------------------------------------ #
    def _check_inputs(self, X, y, sample_weight):
        if sample_weight is None:
            sample_weight = np.ones(X.shape[0])
        else:
            sample_weight = np.asarray(sample_weight, np.float64).reshape(-1)
        if sample_weight.shape[0] != X.shape[0] or X.shape[0] != y.shape[0]:
            raise ValueError("X, y, sample_weight must have matching rows")
        if issparse(y):
            y = np.asarray(y.todense())
        # Average (rather than summed) log-loss, like the reference
        # (stochqn/_logistic.py:159).
        sample_weight = sample_weight / sample_weight.sum()
        return X, y, sample_weight

    def _build_funs(self):
        """Loss/grad/hessvec closures for the protocol engine.

        CSR inputs route through the padded-COO sparse forms
        (models/sparse.py) instead of densifying — the reference keeps
        sparse matrices sparse through its whole driver
        (``stochqn/_optimizers.py:81-112``, ``_logistic.py:36-247``), and
        at CTR scale a densify would not fit in memory."""
        dtype = self.optimizer_kwargs.get("dtype", jnp.float32)
        reg = self.reg_param
        sl = sparse_losses
        if self._is_mult:
            loss_j = jax.jit(losses.multinomial_logistic_loss)
            grad_j = jax.jit(losses.multinomial_logistic_grad)
            hv_j = jax.jit(losses.multinomial_logistic_hessvec)
            sp_loss = jax.jit(sl.sparse_multinomial_logistic_loss,
                              static_argnums=4)
            sp_grad = jax.jit(sl.sparse_multinomial_logistic_grad,
                              static_argnums=4)
            sp_hv = jax.jit(sl.sparse_multinomial_logistic_hessvec,
                            static_argnums=5)
        else:
            loss_j = jax.jit(losses.binary_logistic_loss)
            grad_j = jax.jit(losses.binary_logistic_grad)
            hv_j = jax.jit(losses.binary_logistic_hessvec)
            sp_loss = jax.jit(sl.sparse_binary_logistic_loss,
                              static_argnums=4)
            sp_grad = jax.jit(sl.sparse_binary_logistic_grad,
                              static_argnums=4)
            sp_hv = jax.jit(sl.sparse_binary_logistic_hessvec,
                            static_argnums=5)

        def obj_fun(x, X, y, sample_weight=None, reg_param=reg):
            x = jnp.asarray(x, dtype)
            if issparse(X):
                idx, val = _padded(X, dtype, self._pad_k)
                return float(sp_loss(x, idx, val, y, X.shape[1],
                                     sample_weight, reg_param))
            return float(loss_j(x, jnp.asarray(_densify(X), dtype), y,
                                sample_weight, reg_param))

        def grad_fun(x, X, y, sample_weight=None, reg_param=reg):
            x = jnp.asarray(x, dtype)
            if issparse(X):
                idx, val = _padded(X, dtype, self._pad_k)
                return np.asarray(sp_grad(x, idx, val, y, X.shape[1],
                                          sample_weight, reg_param))
            return np.asarray(grad_j(x, jnp.asarray(_densify(X), dtype), y,
                                     sample_weight, reg_param))

        def hess_vec_fun(x, v, X, y, sample_weight=None, reg_param=reg):
            x = jnp.asarray(x, dtype)
            v = jnp.asarray(v, dtype)
            if issparse(X):
                idx, val = _padded(X, dtype, self._pad_k)
                return np.asarray(sp_hv(x, v, idx, val, y, X.shape[1],
                                        sample_weight, reg_param))
            return np.asarray(hv_j(x, v, jnp.asarray(_densify(X), dtype), y,
                                   sample_weight, reg_param))

        return obj_fun, grad_fun, hess_vec_fun

    def _pred_fun(self):
        if self._is_mult:
            k = self.nclasses

            def pred(x, X):
                if issparse(X):
                    idx, val = _padded(X, x.dtype)
                    return np.asarray(
                        sparse_losses.sparse_multinomial_logistic_predict_proba(
                            jnp.asarray(x), idx, val, X.shape[1], k))
                return np.asarray(losses.multinomial_logistic_predict_proba(
                    jnp.asarray(x), jnp.asarray(_densify(X), x.dtype), k))
            return pred

        def pred(x, X):
            if issparse(X):
                idx, val = _padded(X, x.dtype)
                return np.asarray(
                    sparse_losses.sparse_binary_logistic_predict_proba(
                        jnp.asarray(x), idx, val, X.shape[1]))
            return np.asarray(losses.binary_logistic_predict_proba(
                jnp.asarray(x), jnp.asarray(_densify(X), x.dtype)))
        return pred

    def _initialize_optimizer(self, X, y):
        if self.optimizer is not None:
            return
        self._is_mult = (y.ndim == 2)
        self.nclasses = y.shape[1] if self._is_mult else 2
        obj_fun, grad_fun, hess_vec_fun = self._build_funs()
        n_out = y.shape[1] if self._is_mult else 1
        if self._x_fused is not None:
            # hand fused-trained weights to the protocol optimizer so
            # partial_fit continues the same model
            w0 = np.asarray(self._x_fused)
            self._x_fused = None
        else:
            np.random.seed(self.random_state)
            w0 = np.random.normal(
                size=(X.shape[1] + self.fit_intercept) * n_out)
        kwargs = dict(self.optimizer_kwargs)
        common = dict(x0=w0, grad_fun=grad_fun, obj_fun=obj_fun,
                      pred_fun=self._pred_fun(),
                      random_state=self.random_state)
        if self.optimizer_name == "oLBFGS":
            self.optimizer = oLBFGS(**common, **kwargs)
        elif self.optimizer_name == "SQN":
            self.optimizer = SQN(**common, hess_vec_fun=hess_vec_fun,
                                 **kwargs)
        else:
            self.optimizer = adaQN(**common, **kwargs)

    # ------------------------------------------------------------------ #
    def fit(self, X, y, sample_weight=None):
        """Fit in stochastic batches over multiple epochs.

        ``engine="fused"`` trains fully on-device (one jitted lax.scan per
        epoch, device-side shuffling, jvp Hessian-vector products) —
        typically orders of magnitude faster than the host-driven protocol
        engine on accelerators."""
        X, y, sample_weight = self._check_inputs(X, y, sample_weight)
        if issparse(X):
            # pin the padded width from the full matrix: every batch then
            # compiles to the same [B, k] shape (one program, not one per
            # distinct per-batch max-nnz bucket)
            Xr = X.tocsr()
            knz = int(np.diff(Xr.indptr).max()) if Xr.shape[0] else 1
            self._pad_k = max(8, -(-knz // 8) * 8)
        if self.engine == "fused":
            return self._fit_fused(X, y, sample_weight)
        self._initialize_optimizer(X, y)
        self.optimizer.fit(X, y, sample_weight,
                           {"reg_param": self.reg_param})
        self.is_fitted = True
        return self

    def _fit_fused(self, X, y, sample_weight):
        import jax as _jax
        from stochqn_tpu.core.config import (AdaQNConfig, OLBFGSConfig,
                                             SQNConfig)
        from stochqn_tpu.fused import FusedTrainer, batchify, shuffle_batched
        from stochqn_tpu.utils.metrics import LossHistory

        kw = dict(self.optimizer_kwargs)
        dtype = kw.pop("dtype", jnp.float32)
        step_size = kw.pop("step_size")
        valset_frac = kw.pop("valset_frac", None)
        verbose = kw.pop("verbose", False)
        nepochs = kw.pop("nepochs", 25)
        batches_per_epoch = kw.pop("batches_per_epoch", 25)
        decr_step_size = kw.pop("decr_step_size", "auto")
        tol = kw.pop("tol", 1e-1)
        shuffle = kw.pop("shuffle_data", True)
        kw.pop("random_state", None)
        if decr_step_size == "auto":
            from stochqn_tpu.utils.schedules import step_size_sqrt
            decr = step_size_sqrt
        elif decr_step_size is None:
            decr = None
        else:
            decr = decr_step_size

        self._is_mult = (y.ndim == 2)
        self.nclasses = y.shape[1] if self._is_mult else 2
        n_out = y.shape[1] if self._is_mult else 1
        if self._x_fused is not None:
            w0 = self._x_fused        # warm start (matches protocol engine)
        else:
            np.random.seed(self.random_state)
            w0 = np.random.normal(
                size=(X.shape[1] + self.fit_intercept) * n_out)

        # CSR input trains through the padded-COO sparse forms: features
        # become (indices, values) leaves and no dense [n, n_features]
        # matrix ever exists on device (cf. the reference's sparse-aware
        # driver, ``stochqn/_optimizers.py:81-112``).
        is_sp = issparse(X)
        nf = X.shape[1]
        if is_sp:
            feats = _padded(X, dtype)
        else:
            feats = (jnp.asarray(_densify(X), dtype),)
        if self._is_mult:
            Yd = jnp.asarray(np.asarray(y), dtype)
            if is_sp:
                grad_core = (lambda x, i, v, Y, w, r: sparse_losses
                             .sparse_multinomial_logistic_grad(
                                 x, i, v, Y, nf, w, r))
                loss_core = (lambda x, i, v, Y, w, r: sparse_losses
                             .sparse_multinomial_logistic_loss(
                                 x, i, v, Y, nf, w, r))
                hess_core = (lambda x, hv, i, v, Y, w, r: sparse_losses
                             .sparse_multinomial_logistic_hessvec(
                                 x, hv, i, v, Y, nf, w, r))
            else:
                grad_core = losses.multinomial_logistic_grad
                loss_core = losses.multinomial_logistic_loss
                hess_core = losses.multinomial_logistic_hessvec
        else:
            Yd = jnp.asarray(2.0 * (np.asarray(y) > 0) - 1.0, dtype)
            if is_sp:
                grad_core = (lambda x, i, v, Y, w, r: sparse_losses
                             .sparse_binary_logistic_grad(
                                 x, i, v, Y, nf, w, r))
                loss_core = (lambda x, i, v, Y, w, r: sparse_losses
                             .sparse_binary_logistic_loss(
                                 x, i, v, Y, nf, w, r))
                hess_core = (lambda x, hv, i, v, Y, w, r: sparse_losses
                             .sparse_binary_logistic_hessvec(
                                 x, hv, i, v, Y, nf, w, r))
            else:
                grad_core = losses.binary_logistic_grad
                loss_core = losses.binary_logistic_loss
                hess_core = losses.binary_logistic_hessvec
        Wd = jnp.asarray(sample_weight, dtype)
        reg = self.reg_param

        if valset_frac is not None:
            n_rows = Yd.shape[0]
            n_val = max(1, int(n_rows * valset_frac))
            rng = np.random.default_rng(self.random_state)
            perm = rng.permutation(n_rows)
            val_idx, tr_idx = perm[:n_val], perm[n_val:]
            feats_val = tuple(f[val_idx] for f in feats)
            Y_val, W_val = Yd[val_idx], Wd[val_idx]
            feats = tuple(f[tr_idx] for f in feats)
            Yd, Wd = Yd[tr_idx], Wd[tr_idx]
            has_val = True
        else:
            has_val = False

        def grad_fn(x, batch):
            *fb, Yb, wb = batch
            return grad_core(x, *fb, Yb, wb, reg)

        def obj_fn(x, batch):
            *fb, Yb, wb = batch
            return loss_core(x, *fb, Yb, wb, reg)

        def hess_vec_fn(x, v, batch):
            # Closed-form Hessian-vector product — same closures the
            # protocol engine gets via ``_build_funs`` (and the reference
            # via its ``hess_vec_fun`` callback, ``src/stochqn.c:1105``):
            # 3 big matmuls where the jvp-of-grad default costs ~4.
            *fb, Yb, wb = batch
            return hess_core(x, v, *fb, Yb, wb, reg)

        cfg_cls = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig,
                   "adaQN": AdaQNConfig}[self.optimizer_name]
        cfg = cfg_cls.create(**kw)
        trainer = FusedTrainer(self.optimizer_name, cfg, grad_fn,
                               obj_fn=obj_fn, hess_vec_fn=hess_vec_fn)
        state = trainer.init(jnp.asarray(w0, dtype))

        batch_size = max(1, Yd.shape[0] // int(batches_per_epoch))
        data = batchify((*feats, Yd, Wd), batch_size)
        if self.mesh is not None:
            # shard the state's parameter axis + the example axis; see
            # guided.fit(mesh=...) for semantics (same helper)
            from stochqn_tpu.guided import _GuidedBase
            from stochqn_tpu.parallel import shard_state
            from stochqn_tpu.parallel.mesh import PARAM_AXIS
            n_param = dict(zip(self.mesh.axis_names,
                               self.mesh.devices.shape)).get(PARAM_AXIS, 1)
            n = int(state.x.shape[0])
            if n_param > 1 and n % n_param:
                raise ValueError(
                    f"the mesh's param axis ({n_param}) must divide the "
                    f"parameter count n={n}")
            state = shard_state(state, self.mesh)
            data = _GuidedBase._place_on_mesh(data, self.mesh, batched=True)
        epoch_fn = _jax.jit(trainer.epoch, static_argnames=("aligned",))
        upd_freq = getattr(cfg, "upd_freq", 1)
        if has_val:
            val_loss = _jax.jit(
                lambda x: loss_core(x, *feats_val, Y_val, W_val, reg))
            history = LossHistory(tol)
        key = _jax.random.PRNGKey(self.random_state)
        niter = int(state.niter)  # tracked host-side (see fused.py)
        num_batches = _jax.tree_util.tree_leaves(data)[0].shape[0]
        for epoch in range(int(nepochs)):
            eta = step_size if decr is None else decr(step_size, epoch)
            d = data
            if shuffle:
                key, sub = _jax.random.split(key)
                d = shuffle_batched(data, sub)
            state, _ = epoch_fn(state, d, jnp.asarray(eta, dtype),
                                aligned=niter % upd_freq == 0)
            niter += num_batches
            if has_val:
                lv = float(val_loss(state.x))
                if verbose:
                    print(f"{self.optimizer_name} - epoch {epoch + 1:2d}, "
                          f"val f(x): {lv:.6f}")
                if history.update(lv):
                    break
        self._x_fused = np.asarray(state.x, np.float64)
        self._fused_state = state
        self.is_fitted = True
        return self

    def partial_fit(self, X, y, sample_weight=None, classes=None,
                    decr_step_size=False):
        """Update the model with one user-provided batch."""
        del classes
        X, y, sample_weight = self._check_inputs(X, y, sample_weight)
        self._initialize_optimizer(X, y)
        if decr_step_size:
            self.optimizer.partial_fit(X, y, sample_weight,
                                       {"reg_param": self.reg_param})
        else:
            saved = self.optimizer.decr_step_size
            self.optimizer.decr_step_size = step_size_const
            try:
                self.optimizer.partial_fit(X, y, sample_weight,
                                           {"reg_param": self.reg_param})
            finally:
                self.optimizer.decr_step_size = saved
        self.is_fitted = True
        return self

    def predict(self, X):
        """Predicted class index per row."""
        proba = self._predict_proba_raw(X)
        if self._is_mult:
            return np.argmax(proba, axis=1)
        return (proba >= 0.5).astype(np.uint8)

    def _predict_proba_raw(self, X):
        if self.engine == "fused" or self.optimizer is None:
            x = np.asarray(self.x_)
            return self._pred_fun()(x, X)
        return self.optimizer.predict(X)

    def predict_proba(self, X):
        """Class scores per row (reference semantics: per-class sigmoid for
        multinomial, ``stochqn/_logistic.py:14-20``)."""
        proba = self._predict_proba_raw(X)
        if self._is_mult:
            return proba
        proba = proba.reshape(-1, 1)
        return np.concatenate([1.0 - proba, proba], axis=1)
