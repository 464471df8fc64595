"""Guided ("scikit-learn-like") optimizer API.

Re-implementation of the reference's driver layer
(``stochqn/_optimizers.py:31-785``): classes ``oLBFGS`` / ``SQN`` / ``adaQN``
own the epoch/batch loop, dispatch the free-mode request protocol against
user-supplied gradient / objective / Hessian-vector callables, and provide
``fit`` / ``partial_fit`` / ``predict``.

Semantics preserved from the reference:
  * epoch shuffling via ``np.random.seed(random_state + epoch)`` +
    ``argsort(random(n))`` (``stochqn/_optimizers.py:251-256``),
  * validation split / early stopping on ``tol``
    (``stochqn/_optimizers.py:237-244,271-281``),
  * big-batch assembly: in ``fit`` a contiguous slice covering the last
    ``upd_freq`` batches (``stochqn/_optimizers.py:55-79``); in
    ``partial_fit`` the vstack of every batch stored since the last big-batch
    request (``stochqn/_optimizers.py:81-112``),
  * step-size schedules ``step0 / sqrt(k + 1)`` ("auto") or constant, keyed
    on the epoch in ``fit`` and on the iteration number in ``partial_fit``
    (``stochqn/_optimizers.py:24-28,365-368``).

The user callables here may be plain numpy/scipy functions (reference-
compatible) or JAX functions; for fully on-device training see
:mod:`stochqn_tpu.fused`.
"""
from __future__ import annotations

import warnings
import numpy as np

try:
    from scipy.sparse import issparse, vstack as sp_vstack
except Exception:  # pragma: no cover - scipy is baked into the image
    def issparse(_x):
        return False

    sp_vstack = None

from stochqn_tpu.free import SQN_free, adaQN_free, oLBFGS_free
from stochqn_tpu.utils.schedules import step_size_const, step_size_sqrt


def _resolve_schedule(decr_step_size):
    if decr_step_size == "auto":
        return step_size_sqrt
    if decr_step_size is None:
        return step_size_const
    if not callable(decr_step_size):
        raise ValueError(
            "'decr_step_size' must be 'auto', None, or a callable "
            "f(initial_step_size, k) -> float")
    return decr_step_size


def _slice_rows(arr, start, stop):
    if arr is None:
        return None
    return arr[start:stop]


def _epoch_shuffle_order(random_state, epoch, n_rows):
    """The reference's per-epoch shuffle order (fresh seed + argsort of
    uniforms, ``stochqn/_optimizers.py:251-256``) — the ONE definition all
    engines share so protocol/fused trajectory equality cannot drift."""
    np.random.seed(random_state + epoch)
    return np.argsort(np.random.random(size=n_rows))


def _valset_split(n_rows, frac, random_state):
    """``(train_rows, val_rows)`` exactly as scikit-learn's
    ``train_test_split(..., test_size=frac, random_state=random_state)``
    draws them (its ``ShuffleSplit``): one permutation, the first
    ``ceil(frac * n_rows)`` rows held out."""
    if random_state is None:
        rs = np.random.mtrand._rand
    elif isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)
    order = rs.permutation(n_rows)
    n_val = int(np.ceil(frac * n_rows))
    return order[n_val:], order[:n_val]


def _take_rows(arr, order):
    if arr is None:
        return None
    return arr[order]


class _GuidedBase:
    """Shared driver loop for the three guided optimizers."""

    optimizer_name = None

    def _setup_common(self, x0, grad_fun, obj_fun, pred_fun, hess_vec_fun,
                      batches_per_epoch, step_size, decr_step_size,
                      shuffle_data, random_state, nepochs, valset_frac, tol,
                      callback_epoch, callback_iter, kwargs_cb, verbose):
        if not isinstance(batches_per_epoch, (int, np.integer)) or batches_per_epoch <= 0:
            raise ValueError("'batches_per_epoch' must be a positive integer")
        if step_size <= 0:
            raise ValueError("'step_size' must be positive")
        if nepochs <= 0:
            raise ValueError("'nepochs' must be a positive integer")
        if not callable(grad_fun):
            raise ValueError("'grad_fun' must be callable")
        for name, fn in (("obj_fun", obj_fun), ("pred_fun", pred_fun),
                         ("hess_vec_fun", hess_vec_fun),
                         ("callback_epoch", callback_epoch),
                         ("callback_iter", callback_iter)):
            if fn is not None and not callable(fn):
                raise ValueError(f"'{name}' must be callable or None")
        if valset_frac is not None:
            if not (0.0 < valset_frac < 1.0):
                raise ValueError("'valset_frac' must be in (0, 1) or None")
            if obj_fun is None:
                raise ValueError(
                    "Must provide 'obj_fun' when using a validation fraction")

        self.x = np.asarray(x0, dtype=self.optimizer.dtype).reshape(-1).copy()
        self.n = self.x.shape[0]
        self.step_size = float(step_size)
        self.grad_fun = grad_fun
        self.obj_fun = obj_fun
        self.pred_fun = pred_fun
        self.hess_vec_fun = hess_vec_fun
        self.batches_per_epoch = int(batches_per_epoch)
        self.decr_step_size = _resolve_schedule(decr_step_size)
        self.shuffle_data = bool(shuffle_data)
        self.random_state = 1 if random_state is None else int(random_state)
        self.nepochs = int(nepochs)
        self.valset_frac = valset_frac
        self.tol = float(tol)
        self.callback_epoch = callback_epoch
        self.callback_iter = callback_iter
        self.kwargs_cb = dict(kwargs_cb) if kwargs_cb else {}
        self.verbose = bool(verbose)
        self.epoch = 0
        self.batch_size = None
        self._reset_saved_batch()
        # Prime the protocol: first call always yields a calc_grad request.
        self.req = self.optimizer.run_optimizer(self.x, self.step_size)

    # ------------------------------------------------------------------ #
    @property
    def niter(self) -> int:
        return self.optimizer.niter

    def get_x(self) -> np.ndarray:
        """Copy of the current iterate."""
        return self.x.copy()

    def predict(self, X, additional_kwargs={}):
        if self.pred_fun is None:
            raise ValueError("Must supply 'pred_fun' in order to call predict.")
        return self.pred_fun(self.x, X, **(additional_kwargs or {}))

    # -- stored-batch container (partial_fit big batches) ---------------- #
    def _reset_saved_batch(self):
        self._stored_X, self._stored_y, self._stored_w = [], [], []
        self._last_big = None

    def _save_batch(self, X, y, w):
        self._stored_X.append(X)
        self._stored_y.append(y)
        self._stored_w.append(w)

    @staticmethod
    def _stack(parts):
        n_sparse = sum(issparse(p) for p in parts)
        if 0 < n_sparse < len(parts):
            warnings.warn("Mixing sparse and dense batches; forcing dense.")
            parts = [np.asarray(p.todense()) if issparse(p) else np.asarray(p)
                     for p in parts]
            return np.concatenate(parts, axis=0)
        if n_sparse:
            return sp_vstack(parts)
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    def _pop_stored_batch(self):
        if not self._stored_X:
            # One protocol boundary can issue TWO big-batch requests back
            # to back (adaQN with use_grad_diff + max_incr: the function-
            # value guard then the gradient-difference y) — the second is
            # served from the batch the first one assembled.  The
            # reference crashes here (its container is reset by the first
            # request); reference bugs are deliberately not reproduced
            # (docs/protocol.md).
            if self._last_big is not None:
                return self._last_big
            raise ValueError("No stored batches available for a big-batch "
                             "request; this should not happen.")
        X = self._stack(self._stored_X)
        y = self._stack(self._stored_y)
        if all(w is None for w in self._stored_w):
            w = None
        else:
            if any(w is None for w in self._stored_w):
                warnings.warn("Some stored batches lack sample weights; "
                              "missing weights are set to 1.")
            filled = [np.ones(Xb.shape[0]) if wb is None else wb
                      for Xb, wb in zip(self._stored_X, self._stored_w)]
            w = self._stack(filled)
        self._reset_saved_batch()
        self._last_big = (X, y, w)
        return X, y, w

    def _long_batch_from_epoch(self, X, y, w, batch):
        """Contiguous slice covering the last ``upd_freq`` batches
        (``stochqn/_optimizers.py:55-79``)."""
        upd_freq = self.optimizer.bfgs_upd_freq
        diff = (batch + 1) % upd_freq
        want = upd_freq - diff
        if (batch + 1) >= want:
            st = (batch + 1 - want) * self.batch_size
            end = min(X.shape[0], (batch + 1) * self.batch_size)
        else:
            st = 0
            end = min(X.shape[0], want * self.batch_size)
        X_long = _slice_rows(X, st, end)
        y_long = _slice_rows(y, st, end)
        w_long = _slice_rows(w, st, end)
        if diff > 0:
            self._save_batch(X_long, y_long, w_long)
            X_long, y_long, w_long = self._pop_stored_batch()
        return X_long, y_long, w_long

    # -- request dispatch ------------------------------------------------- #
    def _fit_batch(self, X_batch, y_batch, w_batch, additional_kwargs,
                   is_user_batch=False, X_full=None, y_full=None, w_full=None,
                   X_val=None, y_val=None, w_val=None, batch=None):
        kw = additional_kwargs or {}
        while True:
            task = self.req["task"]
            on = self.req["requested_on"]
            if task in ("calc_grad", "calc_grad_same_batch"):
                self.optimizer.update_gradient(
                    self.grad_fun(on, X_batch, y_batch,
                                  sample_weight=w_batch, **kw))
            elif task == "calc_fun_val_batch" and X_val is not None:
                self.optimizer.update_function(
                    self.obj_fun(on, X_val, y_val, sample_weight=w_val, **kw))
            else:
                if is_user_batch:
                    X_long, y_long, w_long = self._pop_stored_batch()
                else:
                    X_long, y_long, w_long = self._long_batch_from_epoch(
                        X_full, y_full, w_full, batch)
                if task == "calc_grad_big_batch":
                    self.optimizer.update_gradient(
                        self.grad_fun(on, X_long, y_long,
                                      sample_weight=w_long, **kw))
                elif task == "calc_hess_vec":
                    self.optimizer.update_hess_vec(
                        self.hess_vec_fun(on[0], on[1], X_long, y_long,
                                          sample_weight=w_long, **kw))
                elif task == "calc_fun_val_batch":
                    self.optimizer.update_function(
                        self.obj_fun(on, X_long, y_long,
                                     sample_weight=w_long, **kw))
                else:
                    raise ValueError(f"Unexpected task {task!r}")

            if is_user_batch:
                step = self.decr_step_size(self.step_size, self.niter)
            else:
                step = self.decr_step_size(self.step_size, self.epoch)

            self.req = self.optimizer.run_optimizer(self.x, step)

            if self.verbose and (self.req["info"]["iteration_info"]
                                 != "no_problems_encountered"):
                where = (f"at iteration {self.niter}" if is_user_batch else
                         f"at iteration {self.niter}, epoch {self.epoch + 1}")
                print(f"{self.optimizer_name} - {where}: "
                      f"{self.req['info']['iteration_info']}")

            if self.req["task"] == "calc_grad":
                if self.callback_iter is not None:
                    self.callback_iter(self.x, **self.kwargs_cb)
                break

    # -- public drivers ---------------------------------------------------- #
    @staticmethod
    def _ensure_csr(X):
        """Sparse inputs must be CSR for row slicing/shuffling
        (reference: ``_check_sp_type``, ``stochqn/_optimizers.py:48-53``)."""
        if issparse(X) and X.format != "csr":
            warnings.warn("Sparse inputs are cast to CSR for row access.")
            return X.tocsr()
        return X

    def fit(self, X, y, sample_weight=None, additional_kwargs={}, valset=None,
            engine="protocol", mesh=None):
        """Fit over ``nepochs`` epochs of ``batches_per_epoch`` batches,
        optionally early-stopping on a validation objective.

        ``engine="protocol"`` (default) runs the reference-exact
        request/response loop — one host round trip per gradient, any
        callables, sparse inputs, per-iteration callbacks.

        ``engine="fused"`` runs each epoch as ONE jitted on-device program
        (:class:`stochqn_tpu.fused.FusedTrainer`) when the user callables
        are JAX-traceable, falling back to the protocol loop (with a
        warning) otherwise.  Epoch shuffling, step schedules, validation
        early stopping and the final optimizer state are identical to the
        protocol path; big-batch gradients/Hessian-vector products are
        evaluated on the same rows but in a merged order, so trajectories
        match the protocol to float tolerance, not bitwise
        (docs/protocol.md).  For SQN without ``use_grad_diff`` the
        Hessian-vector product uses the user's ``hess_vec_fun`` when that
        callable is JAX-traceable (same values the protocol loop computes),
        and forward-over-reverse ``jax.jvp`` of ``grad_fun`` otherwise.
        Accelerates the loop the reference drives per-request
        (``stochqn/_optimizers.py:199-286``).

        When no per-epoch host control is needed (no ``callback_epoch``,
        no validation early stop), the fused engine runs the WHOLE fit as
        one device program; ``verbose`` problem reports (curvature
        rejects etc.) are then printed after the fit completes rather
        than as they occur — same lines, deferred.

        ``mesh`` (fused engine only): a ``jax.sharding.Mesh`` with
        ``("data", "param")`` axes (:func:`stochqn_tpu.parallel.make_mesh`).
        The optimizer state shards its parameter axis over ``param``, the
        minibatch example axis shards over ``data`` (replicated with a
        fallback when the batch size does not divide the axis), and the
        whole-fit single-dispatch programs apply
        :func:`stochqn_tpu.parallel.epoch_batch_constraint` so the
        device-side shuffle gather keeps data-parallel gradients.
        Trajectories match the unsharded fit to float reduction order
        (locked by ``tests/test_guided_fused.py``).
        """
        if engine not in ("protocol", "fused"):
            raise ValueError("'engine' must be 'protocol' or 'fused'")
        if mesh is not None and engine != "fused":
            raise ValueError("'mesh' requires engine='fused' (the protocol "
                             "loop is host-driven; use "
                             "parallel.data_parallel_grad to shard its "
                             "evaluations instead)")
        # introspection: how the LAST fit dispatched (refined in
        # _fit_fused; stays "protocol" on protocol runs AND on fused
        # runs that fall back before reaching _fit_fused)
        self._fused_single_dispatch = False
        self._fused_dispatch_mode = "protocol"
        X, y = self._ensure_csr(X), self._ensure_csr(y)
        if X.shape[0] <= 0 or X.shape[0] != y.shape[0]:
            raise ValueError("X and y must have matching, nonzero rows")
        if sample_weight is not None and sample_weight.shape[0] != X.shape[0]:
            raise ValueError("sample_weight must match X rows")

        if valset is not None:
            if self.obj_fun is None:
                raise ValueError("Must provide 'obj_fun' to use a validation "
                                 "set.")
            X_val, y_val, w_val = valset
            if self.valset_frac is not None:
                warnings.warn("'valset_frac' is ignored when passing an "
                              "explicit validation set.")
        elif self.valset_frac is not None:
            train, val = _valset_split(X.shape[0], self.valset_frac,
                                       self.random_state)
            X, X_val = _take_rows(X, train), _take_rows(X, val)
            y, y_val = _take_rows(y, train), _take_rows(y, val)
            sample_weight, w_val = (_take_rows(sample_weight, train),
                                    _take_rows(sample_weight, val))
        else:
            X_val, y_val, w_val = None, None, None

        if engine == "fused":
            reason = self._fused_unsupported_reason(X, y, sample_weight)
            if reason is None:
                return self._fit_fused(X, y, sample_weight,
                                       additional_kwargs, X_val, y_val,
                                       w_val, mesh=mesh)
            if mesh is not None:
                raise ValueError(f"mesh requires the fused engine, which "
                                 f"is unavailable here ({reason})")
            warnings.warn(f"engine='fused' unavailable ({reason}); "
                          "falling back to the protocol loop.")

        obj_last_epoch = np.inf
        self.batch_size = int(np.ceil(X.shape[0] / self.batches_per_epoch))
        for self.epoch in range(self.nepochs):
            if self.shuffle_data:
                order = _epoch_shuffle_order(self.random_state, self.epoch,
                                             X.shape[0])
                X, y = _take_rows(X, order), _take_rows(y, order)
                sample_weight = _take_rows(sample_weight, order)

            for batch in range(self.batches_per_epoch):
                st = batch * self.batch_size
                end = min(X.shape[0], (batch + 1) * self.batch_size)
                self._fit_batch(
                    _slice_rows(X, st, end), _slice_rows(y, st, end),
                    _slice_rows(sample_weight, st, end), additional_kwargs,
                    is_user_batch=False, X_full=X, y_full=y,
                    w_full=sample_weight, X_val=X_val, y_val=y_val,
                    w_val=w_val, batch=batch)

            if self.callback_epoch is not None:
                self.callback_epoch(self.x, **self.kwargs_cb)

            if X_val is not None and self.obj_fun is not None:
                obj = float(self.obj_fun(self.x, X_val, y_val,
                                         sample_weight=w_val,
                                         **(additional_kwargs or {})))
                if self.verbose:
                    print(f"{self.optimizer_name} - epoch: {self.epoch + 1:2d},"
                          f" f(x): {obj:12.4f}")
                if (obj_last_epoch - obj) < self.tol and obj <= obj_last_epoch:
                    if self.verbose:
                        print(f"{self.optimizer_name} - terminated "
                              "(decrease below tolerance).")
                    break
                obj_last_epoch = obj
        return self

    # -- fused engine (epochs as single on-device programs) ---------------- #
    def _fused_unsupported_reason(self, X, y, sample_weight):
        """None when ``engine='fused'`` can run; else a human-readable
        reason for the protocol fallback."""
        if self.optimizer.backend != "jax":
            return "the optimizer uses the native (C++) backend"
        if issparse(X) or issparse(y):
            return ("sparse inputs — use the protocol loop or the sparse "
                    "fused path in models.logistic")
        if self.callback_iter is not None:
            return "callback_iter needs per-iteration host control"
        if self.req["task"] != "calc_grad":
            return ("the optimizer is mid-iteration (last request was "
                    f"{self.req['task']!r}); finish it through "
                    "partial_fit first")
        if X.shape[0] % self.batches_per_epoch != 0:
            return (f"{X.shape[0]} rows are not divisible by "
                    f"batches_per_epoch={self.batches_per_epoch} (the "
                    "fused scan needs equal static batch shapes; the "
                    "protocol loop handles the ragged tail)")
        return self._check_traceable(X, y, sample_weight)

    def _wrap_jax_funs(self, additional_kwargs):
        """The guided callables (``fn(x, X, y, sample_weight=..., **kw)``)
        as fused-engine ``fn(x, batch)`` functions; ``batch`` is
        ``(X, y)`` or ``(X, y, w)``.  Returns ``(grad_fn, obj_fn,
        hess_vec_fn)``; the last is ``None`` when the user supplied no
        ``hess_vec_fun``."""
        import jax.numpy as jnp
        kw = dict(additional_kwargs or {})

        def unpack(batch):
            if len(batch) == 3:
                return batch
            Xb, yb = batch
            return Xb, yb, None

        def grad_fn(xv, batch):
            Xb, yb, wb = unpack(batch)
            g = self.grad_fun(xv, Xb, yb, sample_weight=wb, **kw)
            return jnp.asarray(g, xv.dtype).reshape(-1)

        obj_fn = None
        if self.obj_fun is not None:
            def obj_fn(xv, batch):
                Xb, yb, wb = unpack(batch)
                return jnp.asarray(
                    self.obj_fun(xv, Xb, yb, sample_weight=wb, **kw),
                    xv.dtype)

        hess_vec_fn = None
        if self.hess_vec_fun is not None:
            def hess_vec_fn(xv, v, batch):
                Xb, yb, wb = unpack(batch)
                hv = self.hess_vec_fun(xv, v, Xb, yb, sample_weight=wb,
                                       **kw)
                return jnp.asarray(hv, xv.dtype).reshape(-1)
        return grad_fn, obj_fn, hess_vec_fn

    def _fused_needs_obj(self) -> bool:
        """Is ``obj_fun`` traced INTO the fused program (adaQN's
        function-value guard)?  Validation early stopping stays on the
        host either way."""
        return (self.optimizer_name == "adaQN"
                and self.optimizer.max_incr > 0)

    def _check_traceable(self, X, y, sample_weight):
        """Probe the user callables with abstract values; a reason string
        when they are not JAX-traceable."""
        import jax
        import jax.numpy as jnp
        grad_fn, obj_fn, _ = self._wrap_jax_funs({})
        bs = X.shape[0] // self.batches_per_epoch

        def spec(a):
            return jax.ShapeDtypeStruct((bs,) + np.asarray(a).shape[1:],
                                        jnp.asarray(np.asarray(a)[:1]).dtype)
        batch = (spec(X), spec(y))
        if sample_weight is not None:
            batch += (spec(sample_weight),)
        x_spec = jax.ShapeDtypeStruct((self.n,), self.optimizer.dtype)
        try:
            out = jax.eval_shape(grad_fn, x_spec, batch)
            if out.shape != (self.n,):
                return (f"grad_fun returned shape {out.shape}, expected "
                        f"({self.n},)")
            if self._fused_needs_obj():
                jax.eval_shape(obj_fn, x_spec, batch)
        except Exception as exc:   # noqa: BLE001 — any trace failure
            return f"callables are not JAX-traceable: {exc}"
        return None

    @staticmethod
    def _place_on_mesh(data, mesh, batched):
        """Shard the example axis over the ``data`` mesh axis when it
        divides evenly; replicate otherwise (both are correct — GSPMD
        propagates either placement)."""
        import jax
        from stochqn_tpu.parallel import replicated, shard_batches
        from stochqn_tpu.parallel.mesh import DATA_AXIS

        n_data = dict(zip(mesh.axis_names, mesh.devices.shape)).get(
            DATA_AXIS, 1)
        axis = 1 if batched else 0
        leaves = jax.tree_util.tree_leaves(data)
        if n_data > 1 and all(v.shape[axis] % n_data == 0 for v in leaves):
            return shard_batches(data, mesh, batched=batched)
        return jax.tree_util.tree_map(
            lambda v: jax.device_put(v, replicated(mesh)), data)

    def _fit_fused(self, X, y, w, additional_kwargs, X_val, y_val, w_val,
                   mesh=None):
        """Epochs as single jitted device programs.  Same epoch shuffle
        order (``np.random.seed(random_state + epoch)`` + argsort), step
        schedule, early stopping and callbacks as the protocol path; see
        ``fit`` for the documented float-order deltas."""
        import jax
        import jax.numpy as jnp
        from stochqn_tpu.core.enums import INFO_NAMES, Info
        from stochqn_tpu.fused import FusedTrainer, batchify

        dtype = self.optimizer.dtype
        grad_fn, obj_fn, hess_vec_fn = self._wrap_jax_funs(
            additional_kwargs)
        if hess_vec_fn is not None:
            # The user's hess_vec_fun is traced into the program only when
            # it actually traces (the protocol loop never traces it, so a
            # numpy-only callable must keep working here): probe with
            # abstract values and fall back to ``jax.jvp`` of ``grad_fn``
            # — the pre-round-5 behavior — on any failure.
            bs = X.shape[0] // self.batches_per_epoch

            def _spec(a):
                arr = np.asarray(a)
                return jax.ShapeDtypeStruct(
                    (bs,) + arr.shape[1:], jnp.asarray(arr[:1]).dtype)
            probe_batch = (_spec(X), _spec(y))
            if w is not None:
                probe_batch += (_spec(w),)
            x_spec = jax.ShapeDtypeStruct((self.n,), dtype)
            try:
                out = jax.eval_shape(hess_vec_fn, x_spec, x_spec,
                                     probe_batch)
                if out.shape != (self.n,):
                    hess_vec_fn = None
            except Exception:   # noqa: BLE001 — any trace failure
                hess_vec_fn = None
        val_data = None
        if X_val is not None and self._fused_needs_obj():
            # adaQN's in-program guard evaluates on the validation set
            # when one exists (protocol: guided._fit_batch valset branch)
            val_data = (jnp.asarray(X_val), jnp.asarray(y_val))
            if w_val is not None:
                val_data += (jnp.asarray(w_val),)
        batch_constraint = None
        if mesh is not None:
            from stochqn_tpu.parallel import (epoch_batch_constraint,
                                              replicated)
            from stochqn_tpu.parallel.mesh import PARAM_AXIS
            n_param = dict(zip(mesh.axis_names,
                               mesh.devices.shape)).get(PARAM_AXIS, 1)
            if n_param > 1 and self.n % n_param:
                raise ValueError(
                    f"the mesh's param axis ({n_param}) must divide the "
                    f"parameter count n={self.n}")
            batch_constraint = epoch_batch_constraint(mesh)
            if val_data is not None:
                val_data = jax.tree_util.tree_map(
                    lambda v: jax.device_put(v, replicated(mesh)), val_data)
        trainer = FusedTrainer(
            self.optimizer_name, self.optimizer._cfg, grad_fn,
            obj_fn=obj_fn if self._fused_needs_obj() else None,
            val_data=val_data, batch_constraint=batch_constraint,
            hess_vec_fn=hess_vec_fn)

        state = self.optimizer.state
        if mesh is not None:
            from stochqn_tpu.parallel import shard_state
            state = shard_state(state, mesh)
        epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
        self.batch_size = X.shape[0] // self.batches_per_epoch
        L = getattr(self.optimizer, "bfgs_upd_freq", 1)
        niter = int(state.niter)   # tracked host-side (see fused.py)
        kw = additional_kwargs or {}
        obj_last_epoch = np.inf
        last_info = Info.NO_PROBLEMS_ENCOUNTERED

        # Without a per-epoch callback or valset early stop, the WHOLE fit
        # runs as ONE device program: the guided loop is a synchronous
        # caller — ``np.asarray(infos)`` blocks on a device-to-host round
        # trip every epoch — so collapsing N epochs into one dispatch
        # removes N-1 exposed round trips.  The
        # per-epoch shuffle and step decay do NOT force the host loop:
        # both are deterministic in the epoch index, so the composed row
        # orders and step sizes are precomputed and the scan body gathers
        # each epoch's rows on device (jit_epochs_scheduled).
        single_dispatch = (self.callback_epoch is None
                           and X_val is None
                           and self.nepochs > 1)
        self._fused_single_dispatch = single_dispatch
        self._fused_dispatch_mode = "loop"      # refined below
        if single_dispatch:
            parts = (jnp.asarray(X), jnp.asarray(y))
            if w is not None:
                parts += (jnp.asarray(w),)
            B = self.batches_per_epoch
            # aligned=True is only valid when EVERY epoch starts on an
            # update-period boundary; otherwise the generic (misaligned)
            # layout is used — trajectories are identical either way.
            aligned = (niter % L == 0) and (B % L == 0)
            if self.shuffle_data:
                # Cumulative composed permutations, exactly the protocol
                # loop's reshuffle-the-already-shuffled-arrays semantics
                # (reference reassigns X in place,
                # stochqn/_optimizers.py:251-256): cur maps epoch-order
                # position -> absolute row.  (kept == n_rows here —
                # _fused_unsupported_reason rejects ragged row counts
                # before this path; the slice mirrors batchify for
                # clarity.)
                self._fused_dispatch_mode = "scheduled"
                n_rows = X.shape[0]
                kept = B * self.batch_size
                cur = np.arange(n_rows)
                orders = np.empty((self.nepochs, kept), np.int32)
                steps = np.empty((self.nepochs,), np.float64)
                for e in range(self.nepochs):
                    cur = cur[_epoch_shuffle_order(self.random_state, e,
                                                   n_rows)]
                    orders[e] = cur[:kept]
                    steps[e] = self.decr_step_size(self.step_size, e)
                if mesh is not None:
                    parts = self._place_on_mesh(parts, mesh, batched=False)
                state, infos = trainer.jit_epochs_scheduled()(
                    state, parts, jnp.asarray(steps, dtype),
                    jnp.asarray(orders), batch_size=self.batch_size,
                    aligned=aligned)
            else:
                # Fixed batches; the step schedule (if any) rides the
                # scan as a [nepochs] array — no per-epoch gathers.
                const = self.decr_step_size is step_size_const
                self._fused_dispatch_mode = "invariant" if const else "decay"
                if const:
                    steps = jnp.asarray(self.step_size, dtype)
                else:
                    steps = jnp.asarray(
                        [self.decr_step_size(self.step_size, e)
                         for e in range(self.nepochs)], dtype)
                data = batchify(parts, self.batch_size)
                if mesh is not None:
                    data = self._place_on_mesh(data, mesh, batched=True)
                state, infos = trainer.jit_epochs()(
                    state, data, steps,
                    nepochs=self.nepochs, aligned=aligned)
            infos_np = np.asarray(infos)           # [nepochs, B]
            last_info = Info(int(infos_np[-1, -1]))
            if self.verbose:
                for epoch in range(self.nepochs):
                    row = infos_np[epoch]
                    base = niter + epoch * B
                    for i in np.flatnonzero(
                            row != int(Info.NO_PROBLEMS_ENCOUNTERED)):
                        print(f"{self.optimizer_name} - at iteration "
                              f"{base + int(i) + 1}, epoch {epoch + 1}: "
                              f"{INFO_NAMES[Info(int(row[i]))]}")
            self.epoch = self.nepochs - 1
            return self._finish_fused(state, last_info)

        # Shuffling is CUMULATIVE like the protocol loop (each epoch
        # reshuffles the already-shuffled arrays — the reference reassigns
        # X in place, stochqn/_optimizers.py:251-256), so the two engines
        # see identical row orders.
        Xe, ye, we = X, y, w
        for self.epoch in range(self.nepochs):
            if self.shuffle_data:
                order = _epoch_shuffle_order(self.random_state, self.epoch,
                                             X.shape[0])
                Xe, ye = _take_rows(Xe, order), _take_rows(ye, order)
                we = _take_rows(we, order)
            parts = (jnp.asarray(Xe), jnp.asarray(ye))
            if we is not None:
                parts += (jnp.asarray(we),)
            data = batchify(parts, self.batch_size)
            if mesh is not None:
                data = self._place_on_mesh(data, mesh, batched=True)
            eta = self.decr_step_size(self.step_size, self.epoch)
            state, infos = epoch_fn(state, data, jnp.asarray(eta, dtype),
                                    aligned=niter % L == 0)
            niter += self.batches_per_epoch
            infos_np = np.asarray(infos)
            last_info = Info(int(infos_np[-1]))
            if self.verbose:
                base = niter - self.batches_per_epoch
                for i in np.flatnonzero(
                        infos_np != int(Info.NO_PROBLEMS_ENCOUNTERED)):
                    print(f"{self.optimizer_name} - at iteration "
                          f"{base + int(i) + 1}, epoch {self.epoch + 1}: "
                          f"{INFO_NAMES[Info(int(infos_np[i]))]}")

            x_np = np.asarray(state.x)
            if self.callback_epoch is not None:
                self.callback_epoch(x_np, **self.kwargs_cb)

            if X_val is not None and self.obj_fun is not None:
                obj = float(self.obj_fun(x_np, X_val, y_val,
                                         sample_weight=w_val, **kw))
                if self.verbose:
                    print(f"{self.optimizer_name} - epoch: "
                          f"{self.epoch + 1:2d}, f(x): {obj:12.4f}")
                if (obj_last_epoch - obj) < self.tol and obj <= obj_last_epoch:
                    if self.verbose:
                        print(f"{self.optimizer_name} - terminated "
                              "(decrease below tolerance).")
                    break
                obj_last_epoch = obj

        return self._finish_fused(state, last_info)

    def _finish_fused(self, state, last_info):
        """Hand the live state back to the free-mode protocol object: the
        fused steps end exactly at an iteration boundary (section 1,
        awaiting calc_grad), so partial_fit / run_optimizer continue
        seamlessly (tested: tests/test_guided.py fused<->protocol resume)."""
        from stochqn_tpu.core.enums import INFO_NAMES

        self.optimizer.state = state
        # np.array (not asarray): device arrays view as read-only, and the
        # protocol loop writes the iterate back into self.x in place
        self.x = np.array(state.x, dtype=self.x.dtype).reshape(-1)
        self.req = {
            "task": "calc_grad",
            "requested_on": self.x.copy(),
            "info": {
                "x_changed_in_run": True,
                "iteration_number": int(state.niter),
                "iteration_info": INFO_NAMES[last_info],
            },
        }
        return self

    def partial_fit(self, X, y, sample_weight=None, additional_kwargs={}):
        """Update with a single user-provided batch.

        For SQN (and adaQN with ``use_grad_diff`` or ``max_incr``) the batch
        is retained in a stored-batch container that serves future big-batch
        / Hessian-vector requests (``stochqn/_optimizers.py:288-337``)."""
        X, y = self._ensure_csr(X), self._ensure_csr(y)
        if self._saves_batches():
            self._save_batch(X, y, sample_weight)
        self._fit_batch(X, y, sample_weight, additional_kwargs,
                        is_user_batch=True)
        return self

    def _saves_batches(self) -> bool:
        return False

    def __repr__(self):
        return (f"{type(self).__name__}(n={self.n}, "
                f"batches_per_epoch={self.batches_per_epoch}, "
                f"step_size={self.step_size}, iteration {self.niter})")


class oLBFGS(_GuidedBase):
    """Guided oLBFGS (reference: ``stochqn/_optimizers.py:416-522``)."""

    optimizer_name = "oLBFGS"

    def __init__(self, x0, grad_fun, obj_fun=None, pred_fun=None,
                 batches_per_epoch=25, step_size=1e-3, decr_step_size="auto",
                 shuffle_data=True, random_state=1, nepochs=25,
                 valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 hess_init=None, min_curvature=1e-4, y_reg=None,
                 check_nan=True, nthreads=-1, use_float=False, dtype=None,
                 backend="jax", pairs_bf16=False, pairs_interleaved=False):
        self.optimizer = oLBFGS_free(
            mem_size=mem_size, hess_init=hess_init,
            min_curvature=min_curvature, y_reg=y_reg, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            backend=backend, pairs_bf16=pairs_bf16,
            pairs_interleaved=pairs_interleaved)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, None,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)


class SQN(_GuidedBase):
    """Guided SQN (reference: ``stochqn/_optimizers.py:524-650``)."""

    optimizer_name = "SQN"

    def __init__(self, x0, grad_fun, obj_fun=None, hess_vec_fun=None,
                 pred_fun=None, batches_per_epoch=25, step_size=1e-3,
                 decr_step_size="auto", shuffle_data=True, random_state=1,
                 nepochs=25, valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 bfgs_upd_freq=20, min_curvature=1e-4, y_reg=None,
                 use_grad_diff=False, check_nan=True, nthreads=-1,
                 use_float=False, dtype=None, backend="jax",
                 pairs_bf16=False, pairs_interleaved=False):
        if not use_grad_diff and hess_vec_fun is None:
            raise ValueError("Without 'use_grad_diff', must provide "
                             "'hess_vec_fun'.")
        if hess_vec_fun is not None and use_grad_diff:
            warnings.warn("'hess_vec_fun' is ignored with "
                          "'use_grad_diff=True'.")
        self.optimizer = SQN_free(
            mem_size=mem_size, bfgs_upd_freq=bfgs_upd_freq,
            min_curvature=min_curvature, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            backend=backend, pairs_bf16=pairs_bf16,
            pairs_interleaved=pairs_interleaved)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, hess_vec_fun,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)

    def _saves_batches(self) -> bool:
        return True


class adaQN(_GuidedBase):
    """Guided adaQN (reference: ``stochqn/_optimizers.py:652-785``)."""

    optimizer_name = "adaQN"

    def __init__(self, x0, grad_fun, obj_fun=None, pred_fun=None,
                 batches_per_epoch=25, step_size=1e-1, decr_step_size=None,
                 shuffle_data=True, random_state=1, nepochs=25,
                 valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 fisher_size=100, bfgs_upd_freq=20, max_incr=1.01,
                 min_curvature=1e-4, y_reg=None, scal_reg=1e-4,
                 rmsprop_weight=None, use_grad_diff=False, check_nan=True,
                 nthreads=-1, use_float=False, dtype=None,
                 h0_exact_reference=True, backend="jax"):
        if max_incr is not None and obj_fun is None:
            raise ValueError("Must provide 'obj_fun' when passing 'max_incr'.")
        if use_grad_diff and fisher_size is not None:
            warnings.warn("'fisher_size' ignored with 'use_grad_diff=True'.")
        self.optimizer = adaQN_free(
            mem_size=mem_size, fisher_size=fisher_size,
            bfgs_upd_freq=bfgs_upd_freq, max_incr=max_incr,
            min_curvature=min_curvature, scal_reg=scal_reg,
            rmsprop_weight=rmsprop_weight, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            h0_exact_reference=h0_exact_reference, backend=backend)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, None,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)

    def _saves_batches(self) -> bool:
        return (self.optimizer.use_grad_diff
                or self.optimizer.max_incr > 0)
