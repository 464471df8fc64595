"""ctypes bindings for the native C++ optimizer core.

The native tier (``native/``) implements the same three state machines in
header-only C++17 and exposes a C ABI; this module loads (and if necessary
builds) the shared library and wraps it in classes with the same
``run/update`` surface the JAX transition functions provide, so the
free-mode API can run with ``backend="native"`` — a zero-JAX CPU engine
with per-call latency in microseconds, the role the reference's C core +
Cython bridge played.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libstochqn_native.so")

_lock = threading.Lock()
_lib = None

# Flags that determine the core's floating-point behavior: -O3 plus
# -march=native enable FMA contraction, -fopenmp fixes the reduction
# structure.  The R-shim build (tests/test_r_shim.py) compiles a SECOND
# copy of the same core and asserts bit-identical trajectories against
# this backend — that contract holds only when both builds use exactly
# these flags, so it imports this tuple rather than restating them.
NUMERIC_FLAGS = ("-O3", "-march=native", "-fopenmp")


def _build_library() -> str:
    if not os.path.isdir(_NATIVE_DIR):
        raise RuntimeError(
            "native C++ sources not found (the native backend requires a "
            f"source checkout with the native/ directory; looked in "
            f"{_NATIVE_DIR})")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    src = os.path.join(_NATIVE_DIR, "src", "capi.cpp")
    inc = os.path.join(_NATIVE_DIR, "include")
    # Build to a private temp file and atomically rename: another process
    # (parallel test workers) must never dlopen a partially written .so.
    tmp_path = f"{_LIB_PATH}.tmp.{os.getpid()}"
    cmd = ["g++", *NUMERIC_FLAGS, "-std=c++17", "-shared", "-fPIC",
           f"-I{inc}", src, "-o", tmp_path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise RuntimeError(
            "native library build failed:\n" + proc.stderr[-4000:])
    os.replace(tmp_path, _LIB_PATH)
    return _LIB_PATH


def _sources_newer_than_lib() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for root, _dirs, files in os.walk(_NATIVE_DIR):
        if os.path.abspath(root).startswith(os.path.abspath(_BUILD_DIR)):
            continue
        for f in files:
            if f.endswith((".hpp", ".cpp", ".h")):
                if os.path.getmtime(os.path.join(root, f)) > lib_mtime:
                    return True
    return False


def load_library() -> ctypes.CDLL:
    """Load the native library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _sources_newer_than_lib():
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        _configure(lib)
        _lib = lib
        return lib


def library_path() -> str:
    """Path of the built shared library (building it on first use) — for
    external consumers linking against the C ABI (native/include/
    stochqn_native.h)."""
    load_library()
    return _LIB_PATH


def native_available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def _configure(lib: ctypes.CDLL) -> None:
    for suffix, real in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
        rp = ctypes.POINTER(real)
        ip = ctypes.POINTER(ctypes.c_int)
        lp = ctypes.POINTER(ctypes.c_long)

        f = getattr(lib, f"sqn_native_olbfgs_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_size_t, ctypes.c_size_t, real, real, real,
                      ctypes.c_int]
        getattr(lib, f"sqn_native_olbfgs_destroy_{suffix}").argtypes = \
            [ctypes.c_void_p]
        f = getattr(lib, f"sqn_native_olbfgs_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_size_t, real, rp, rp, rp,
                      ip, ip, lp]

        f = getattr(lib, f"sqn_native_sqn_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
                      real, real, ctypes.c_int, ctypes.c_int]
        getattr(lib, f"sqn_native_sqn_destroy_{suffix}").argtypes = \
            [ctypes.c_void_p]
        f = getattr(lib, f"sqn_native_sqn_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_size_t, real, rp, rp, rp,
                      rp, rp, ip, ip, lp]

        f = getattr(lib, f"sqn_native_adaqn_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
                      ctypes.c_size_t, real, real, real, real, real,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
        getattr(lib, f"sqn_native_adaqn_destroy_{suffix}").argtypes = \
            [ctypes.c_void_p]
        f = getattr(lib, f"sqn_native_adaqn_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_size_t, real, rp, rp, real,
                      rp, ip, ip, lp]


class _NativeBase:
    """Shared ctypes plumbing for the three native optimizers."""

    kind = None  # "olbfgs" | "sqn" | "adaqn"

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        if self.dtype == np.float64:
            self._sfx = "f64"
            self._real = ctypes.c_double
        elif self.dtype == np.float32:
            self._sfx = "f32"
            self._real = ctypes.c_float
        else:
            raise ValueError("native backend supports float32/float64 only")
        self._lib = load_library()
        self._handle = None
        self._n = None

    def _fn(self, op):
        return getattr(self._lib, f"sqn_native_{self.kind}_{op}_{self._sfx}")

    def _alloc_buffers(self, n):
        self._n = n
        self.x = np.zeros(n, dtype=self.dtype)
        self.gradient = np.zeros(n, dtype=self.dtype)
        self.req_out = np.zeros(n, dtype=self.dtype)
        self._info = ctypes.c_int(0)
        self._changed = ctypes.c_int(0)
        self._niter = ctypes.c_long(0)
        # Everything a run() call needs, bound ONCE: at small n the
        # optimizer math is microseconds, so per-call Python work
        # (getattr, f-strings, pointer/byref construction) is a visible
        # share of a call.  Buffers never reallocate after
        # start(), so the cached pointers stay valid.
        self._run_fn = self._fn("run")
        self._out_refs = (ctypes.byref(self._info),
                          ctypes.byref(self._changed),
                          ctypes.byref(self._niter))

    def _ptr(self, arr):
        return arr.ctypes.data_as(ctypes.POINTER(self._real))

    @property
    def niter(self) -> int:
        return int(self._niter.value)

    def __del__(self):
        try:
            if self._handle:
                self._fn("destroy")(self._handle)
        except Exception:
            pass


class NativeOLBFGS(_NativeBase):
    kind = "olbfgs"

    def __init__(self, mem_size=10, hess_init=0.0, min_curvature=1e-4,
                 y_reg=0.0, check_nan=True, dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, hess_init, min_curvature, y_reg,
                      int(check_nan))

    def start(self, x0):
        x0 = np.asarray(x0, self.dtype).reshape(-1)
        self._alloc_buffers(x0.shape[0])
        self.x[:] = x0
        mem_size, hess_init, min_curv, y_reg, check_nan = self._args
        self._handle = self._fn("create")(
            self._n, mem_size, self._real(hess_init), self._real(min_curv),
            self._real(y_reg), check_nan)
        if not self._handle:
            raise ValueError("invalid native optimizer parameters")
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.req_out))

    def run(self, step_size):
        h, n, xp, gp, rp = self._run_args
        task = self._run_fn(h, n, self._real(step_size), xp, gp, rp,
                            *self._out_refs)
        return (task, self._info.value, bool(self._changed.value),
                self.req_out, None)


class NativeSQN(_NativeBase):
    kind = "sqn"

    def __init__(self, mem_size=10, upd_freq=20, min_curvature=1e-4,
                 y_reg=0.0, use_grad_diff=False, check_nan=True,
                 dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, upd_freq, min_curvature, y_reg,
                      int(use_grad_diff), int(check_nan))

    def start(self, x0):
        x0 = np.asarray(x0, self.dtype).reshape(-1)
        self._alloc_buffers(x0.shape[0])
        self.x[:] = x0
        self.hess_vec = np.zeros(self._n, dtype=self.dtype)
        self.req_vec_out = np.zeros(self._n, dtype=self.dtype)
        mem, upd, mc, yr, ugd, cn = self._args
        self._handle = self._fn("create")(
            self._n, mem, upd, self._real(mc), self._real(yr), ugd, cn)
        if not self._handle:
            raise ValueError("invalid native optimizer parameters")
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.hess_vec),
                          self._ptr(self.req_out),
                          self._ptr(self.req_vec_out))

    def run(self, step_size):
        h, n, xp, gp, hp, rp, rvp = self._run_args
        task = self._run_fn(h, n, self._real(step_size), xp, gp, hp, rp,
                            rvp, *self._out_refs)
        return (task, self._info.value, bool(self._changed.value),
                self.req_out, self.req_vec_out)


class NativeAdaQN(_NativeBase):
    kind = "adaqn"

    def __init__(self, mem_size=10, fisher_size=100, upd_freq=20,
                 max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
                 rmsprop_weight=0.0, y_reg=0.0, use_grad_diff=False,
                 check_nan=True, h0_exact_reference=True, dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, fisher_size, upd_freq, max_incr,
                      min_curvature, scal_reg, rmsprop_weight, y_reg,
                      int(use_grad_diff), int(check_nan),
                      int(h0_exact_reference))
        self.f = 0.0

    def start(self, x0):
        x0 = np.asarray(x0, self.dtype).reshape(-1)
        self._alloc_buffers(x0.shape[0])
        self.x[:] = x0
        (mem, fs, upd, mi, mc, sr, rw, yr, ugd, cn, h0ref) = self._args
        self._handle = self._fn("create")(
            self._n, mem, fs, upd, self._real(mi), self._real(mc),
            self._real(sr), self._real(rw), self._real(yr), ugd, cn, h0ref)
        if not self._handle:
            raise ValueError("invalid native optimizer parameters")
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.req_out))

    def run(self, step_size):
        h, n, xp, gp, rp = self._run_args
        task = self._run_fn(h, n, self._real(step_size), xp, gp,
                            self._real(self.f), rp, *self._out_refs)
        return (task, self._info.value, bool(self._changed.value),
                self.req_out, None)
