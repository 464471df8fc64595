"""Free-mode optimizer API — the reference's request/response protocol.

Drop-in equivalents of the reference's ``oLBFGS_free`` / ``SQN_free`` /
``adaQN_free`` (``stochqn/_optimizers.py:929-1364``): the user owns the
evaluation loop, the optimizer answers every call with a request dict

    {"task": str,
     "requested_on": array | (array, array),
     "info": {"x_changed_in_run": bool,
              "iteration_number": int,
              "iteration_info": str}}

identical in schema and task ordering to the reference
(``stochqn/_optimizers.py:1004-1016``).

Under the hood each call dispatches one jit-compiled ``advance`` transition
(``stochqn_tpu.core.{olbfgs,sqn,adaqn}``) whose state lives on device; the
only per-call host traffic is the scalars in the request dict plus the
evaluation-point array the user asked for.  For fully on-device training
loops use :mod:`stochqn_tpu.fused` instead.

Dtype note: like the reference, ``use_float=False`` selects float64, which
needs ``jax.config.update("jax_enable_x64", True)``; the H100 runs float64
natively, at a fraction of its float32 rate.  Pass ``use_float=True``
(float32), or set ``dtype=`` explicitly (including ``jnp.bfloat16``).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core import adaqn, olbfgs, sqn
from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.core.enums import INFO_NAMES, TASK_NAMES, Info, Task


def _resolve_dtype(use_float: bool, dtype, backend: str = "jax") -> jnp.dtype:
    if dtype is not None:
        return jnp.dtype(dtype)
    if use_float:
        return jnp.dtype(jnp.float32)
    if backend == "native" or jax.config.jax_enable_x64:
        # the C++ tier supports float64 natively, independent of JAX x64
        return jnp.dtype(jnp.float64)
    warnings.warn(
        "use_float=False requests float64 but jax x64 mode is disabled; "
        "falling back to float32. Enable x64 or pass use_float=True / "
        "dtype=... to silence this.")
    return jnp.dtype(jnp.float32)


class _StochQNFree:
    """Shared machinery for the three free-mode wrappers.

    ``backend="jax"`` (default) runs the jitted device state machines;
    ``backend="native"`` runs the C++ core (``native/``) through ctypes —
    a zero-JAX CPU engine with microsecond per-call latency, the role the
    reference's C core + Cython bridge played.
    """

    _cfg = None          # set by subclass __init__
    _advance_fn = None   # staticmethod advance(cfg, state, *inputs)

    def __init__(self, backend: str = "jax"):
        if backend not in ("jax", "native"):
            raise ValueError("backend must be 'jax' or 'native'")
        self.backend = backend
        self.state = None
        self._native = None
        self._n = None
        self._gradient = None

    def _make_native(self):
        raise NotImplementedError

    # -- evaluation inputs -------------------------------------------------
    def _check_len(self, arr, what: str):
        """Length validation mirroring the reference's update_gradient
        checks (``stochqn/_optimizers.py:917-927``)."""
        if self._n is not None and arr.shape[0] != self._n:
            raise ValueError(
                f"{what} has {arr.shape[0]} elements, expected {self._n}")
        return arr

    def update_gradient(self, gradient) -> None:
        """Pass the requested gradient to the optimizer (any of the
        ``calc_grad*`` tasks)."""
        if self.backend == "native":
            arr = np.asarray(gradient, self._native.dtype).reshape(-1)
            if arr.shape[0] != self._n:
                raise ValueError(f"gradient has {arr.shape[0]} elements, "
                                 f"expected {self._n}")
            self._native.gradient[:] = arr
            return
        gradient = self._check_len(
            jnp.asarray(gradient, self.dtype).reshape(-1), "gradient")
        self._gradient = gradient

    # -- protocol ----------------------------------------------------------
    def _initialize(self, x) -> None:
        if self.backend == "native":
            self._native = self._make_native()
            self._native.start(np.asarray(x, self.dtype).reshape(-1))
            self._n = self._native.x.shape[0]
            return
        x = jnp.asarray(x, self.dtype).reshape(-1)
        self._n = x.shape[0]
        self.state = self._init_fn(x, self._cfg)
        self._gradient = jnp.zeros((self._n,), self.dtype)

    def _extra_inputs(self) -> Tuple:
        return ()

    def run_optimizer(self, x, step_size) -> dict:
        """Advance the optimizer until its next external request.

        ``x`` is consumed on the first call; afterwards the internal state
        is authoritative and, when ``x`` is a numpy array, the new iterate
        is written back into it in place (matching the reference's in-place
        mutation contract, ``stochqn/_optimizers.py:997-999``).
        """
        if self.state is None and self._native is None:
            self._initialize(x)

        if self.backend == "native":
            task_i, info_i, changed, req_out, req_vec_out = \
                self._native.run(float(step_size))
            task = Task(task_i)
            info = Info(info_i)
            niter = self._native.niter
            if isinstance(x, np.ndarray) and x.size == self._n:
                # copy into x's own memory (reshape(-1) could be a copy for
                # non-contiguous views)
                np.copyto(x, self._native.x.astype(x.dtype).reshape(x.shape))
            if task == Task.CALC_HESS_VEC:
                requested_on = (req_out.copy(), req_vec_out.copy())
            else:
                requested_on = req_out.copy()
        else:
            new_state, res = self._advance_jit(
                self._cfg, self.state, self._gradient, *self._extra_inputs(),
                jnp.asarray(step_size, self.dtype))
            self.state = new_state

            task = Task(int(res.task))
            info = Info(int(res.info))
            changed = bool(res.x_changed)
            niter = int(new_state.niter)
            section = int(new_state.section)

            if isinstance(x, np.ndarray) and x.size == self._n:
                np.copyto(x, np.asarray(self.state.x,
                                        dtype=x.dtype).reshape(x.shape))
            requested_on = self._requested_on(task, section)

        return {
            "task": TASK_NAMES[task],
            "requested_on": requested_on,
            "info": {
                "x_changed_in_run": bool(changed),
                "iteration_number": niter,
                "iteration_info": INFO_NAMES[info],
            },
        }

    # -- helpers -----------------------------------------------------------
    @property
    def n(self) -> Optional[int]:
        return self._n

    @property
    def niter(self) -> int:
        if self.backend == "native":
            return 0 if self._native is None else self._native.niter
        return 0 if self.state is None else int(self.state.niter)

    def _requested_on(self, task: Task, section: int):
        raise NotImplementedError

    def __repr__(self):
        """Human-readable summary (the analogue of the reference's
        ``print.*_free`` S3 methods, ``R/optimizers_free.R:688-735``)."""
        name = type(self).__name__
        cfg = ", ".join(f"{f}={getattr(self._cfg, f)!r}"
                        for f in self._cfg.__dataclass_fields__)
        status = ("not yet initialized" if self._n is None else
                  f"n={self._n}, iteration {self.niter}")
        return f"{name}({cfg}) [{status}, backend={self.backend}]"


class oLBFGS_free(_StochQNFree):
    """oLBFGS in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:938-943``)::

        ==== loop ====
        * calc_grad
        * calc_grad_same_batch   (may be skipped after a rejected direction)
        ==============
    """

    _init_fn = staticmethod(olbfgs.init)

    def __init__(self, mem_size=10, hess_init=None, min_curvature=1e-4,
                 y_reg=None, check_nan=True, nthreads=-1, use_float=False,
                 dtype=None, backend="jax", pairs_bf16=False,
                 pairs_interleaved=False):
        super().__init__(backend)
        del nthreads  # parallelism is XLA's (or the compiler's) job here
        self.dtype = _resolve_dtype(use_float, dtype, backend)
        if backend != "jax" and (pairs_bf16 or pairs_interleaved):
            raise ValueError("pairs_bf16/pairs_interleaved are JAX-engine "
                             "options (backend='jax' only)")
        self._cfg = OLBFGSConfig.create(
            mem_size=mem_size, hess_init=hess_init,
            min_curvature=min_curvature, y_reg=y_reg, check_nan=check_nan,
            pairs_bf16=pairs_bf16, pairs_interleaved=pairs_interleaved)
        if backend == "jax":
            self._advance_jit = jax.jit(olbfgs.advance, static_argnums=0)

    def _make_native(self):
        from stochqn_tpu.native_backend import NativeOLBFGS
        c = self._cfg
        return NativeOLBFGS(mem_size=c.mem_size, hess_init=c.hess_init,
                            min_curvature=c.min_curvature, y_reg=c.y_reg,
                            check_nan=c.check_nan, dtype=self.dtype)

    def _requested_on(self, task: Task, section: int):
        return np.asarray(self.state.x)


class SQN_free(_StochQNFree):
    """SQN in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:1057-1066``)::

        ==== loop ====
        * calc_grad  (x upd_freq)
        * calc_grad_big_batch  (use_grad_diff)  |  calc_hess_vec
        ==============
    """

    _init_fn = staticmethod(sqn.init)

    def __init__(self, mem_size=10, bfgs_upd_freq=20, min_curvature=1e-4,
                 y_reg=None, use_grad_diff=False, check_nan=True, nthreads=-1,
                 use_float=False, dtype=None, backend="jax",
                 pairs_bf16=False, pairs_interleaved=False):
        super().__init__(backend)
        del nthreads
        self.dtype = _resolve_dtype(use_float, dtype, backend)
        if backend != "jax" and (pairs_bf16 or pairs_interleaved):
            raise ValueError("pairs_bf16/pairs_interleaved are JAX-engine "
                             "options (backend='jax' only)")
        self._cfg = SQNConfig.create(
            mem_size=mem_size, bfgs_upd_freq=bfgs_upd_freq,
            min_curvature=min_curvature, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            pairs_bf16=pairs_bf16, pairs_interleaved=pairs_interleaved)
        if backend == "jax":
            self._advance_jit = jax.jit(sqn.advance, static_argnums=0)
        self._hess_vec = None

    def _make_native(self):
        from stochqn_tpu.native_backend import NativeSQN
        c = self._cfg
        return NativeSQN(mem_size=c.mem_size, upd_freq=c.upd_freq,
                         min_curvature=c.min_curvature, y_reg=c.y_reg,
                         use_grad_diff=c.use_grad_diff,
                         check_nan=c.check_nan, dtype=self.dtype)

    @property
    def bfgs_upd_freq(self) -> int:
        return self._cfg.upd_freq

    @property
    def use_grad_diff(self) -> bool:
        return self._cfg.use_grad_diff

    def _initialize(self, x) -> None:
        super()._initialize(x)
        self._hess_vec = jnp.zeros((self._n,), self.dtype)

    def update_hess_vec(self, hess_vec) -> None:
        """Pass the requested Hessian-vector product (task
        ``calc_hess_vec``)."""
        if self.backend == "native":
            arr = np.asarray(hess_vec, self._native.dtype).reshape(-1)
            if arr.shape[0] != self._n:
                raise ValueError(f"hess_vec has {arr.shape[0]} elements, "
                                 f"expected {self._n}")
            self._native.hess_vec[:] = arr
            return
        self._hess_vec = self._check_len(
            jnp.asarray(hess_vec, self.dtype).reshape(-1), "hess_vec")

    def _extra_inputs(self) -> Tuple:
        return (self._hess_vec,)

    def _requested_on(self, task: Task, section: int):
        st = self.state
        if task == Task.CALC_HESS_VEC:
            return (np.asarray(st.x_sum), np.asarray(st.mem.s_pending))
        if task == Task.CALC_GRAD_BIG_BATCH:
            return np.asarray(st.x_avg_prev if section == 2 else st.x_sum)
        return np.asarray(st.x)


class adaQN_free(_StochQNFree):
    """adaQN in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:1201-1210``)::

        ==== loop ====
        * calc_grad  (x upd_freq)
        if max_incr:        * calc_fun_val_batch
        if use_grad_diff:   * calc_grad_big_batch  (skipped on func_increased)
        ==============
    """

    _init_fn = staticmethod(adaqn.init)

    def __init__(self, mem_size=10, fisher_size=100, bfgs_upd_freq=20,
                 max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
                 rmsprop_weight=None, y_reg=None, use_grad_diff=False,
                 check_nan=True, nthreads=-1, use_float=False, dtype=None,
                 h0_exact_reference=True, backend="jax"):
        super().__init__(backend)
        del nthreads
        self.dtype = _resolve_dtype(use_float, dtype, backend)
        self._cfg = AdaQNConfig.create(
            mem_size=mem_size, fisher_size=fisher_size,
            bfgs_upd_freq=bfgs_upd_freq, max_incr=max_incr,
            min_curvature=min_curvature, scal_reg=scal_reg,
            rmsprop_weight=rmsprop_weight, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            h0_exact_reference=h0_exact_reference)
        if backend == "jax":
            self._advance_jit = jax.jit(adaqn.advance, static_argnums=0)
        self._f = None

    def _make_native(self):
        from stochqn_tpu.native_backend import NativeAdaQN
        c = self._cfg
        return NativeAdaQN(
            mem_size=c.mem_size, fisher_size=c.fisher_size,
            upd_freq=c.upd_freq, max_incr=c.max_incr,
            min_curvature=c.min_curvature, scal_reg=c.scal_reg,
            rmsprop_weight=c.rmsprop_weight, y_reg=c.y_reg,
            use_grad_diff=c.use_grad_diff, check_nan=c.check_nan,
            h0_exact_reference=c.h0_exact_reference, dtype=self.dtype)

    @property
    def bfgs_upd_freq(self) -> int:
        return self._cfg.upd_freq

    @property
    def max_incr(self) -> float:
        return self._cfg.max_incr

    @property
    def use_grad_diff(self) -> bool:
        return self._cfg.use_grad_diff

    def _initialize(self, x) -> None:
        super()._initialize(x)
        self._f = jnp.zeros((), self.dtype)

    def update_function(self, fun) -> None:
        """Pass the requested function value (task ``calc_fun_val_batch``)."""
        if self.backend == "native":
            self._native.f = float(fun)
            return
        self._f = jnp.asarray(fun, self.dtype)

    def _extra_inputs(self) -> Tuple:
        return (self._f,)

    def _requested_on(self, task: Task, section: int):
        st = self.state
        if task in (Task.CALC_GRAD_BIG_BATCH, Task.CALC_FUN_VAL_BATCH):
            return np.asarray(st.x_avg_prev if section in (2, 3) else st.x_sum)
        return np.asarray(st.x)
