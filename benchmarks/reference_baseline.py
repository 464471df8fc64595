"""Measure the reference C core's throughput on this machine.

Compiles the UNMODIFIED reference sources from ``/root/reference`` at
runtime (nothing is copied into this repo) against a small local BLAS shim,
then drives ``run_SQN`` through its public C ABI with numpy gradient /
Hessian-vector evaluations on the same BibTeX-shaped workload as
``bench.py``, and records iters/s to ``BASELINE_MEASURED.json``.

Run:  python benchmarks/reference_baseline.py
Skipped automatically if ``/root/reference`` is absent.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REFERENCE = "/root/reference"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Same shapes as bench.py
N_FEATURES = 1836
N_CLASSES = 159
BATCH_SIZE = 50
NUM_BATCHES = 120
UPD_FREQ = 20
REG = 1e-1
STEP = 1e-2

BLASFUNS_H = r"""
#ifndef SHIM_BLASFUNS_H
#define SHIM_BLASFUNS_H
enum CBLAS_ORDER {CblasRowMajor=101, CblasColMajor=102};
enum CBLAS_TRANSPOSE {CblasNoTrans=111, CblasTrans=112, CblasConjTrans=113};
typedef enum CBLAS_ORDER CBLAS_ORDER;
typedef enum CBLAS_TRANSPOSE CBLAS_TRANSPOSE;
double cblas_ddot(int n, const double *x, int incx, const double *y, int incy);
void cblas_daxpy(int n, double a, const double *x, int incx, double *y, int incy);
void cblas_dscal(int n, double alpha, double *x, int incx);
double cblas_dnrm2(int n, const double *x, int incx);
void cblas_dgemv(CBLAS_ORDER order, CBLAS_TRANSPOSE trans, int m, int n,
                 double alpha, const double *a, int lda, const double *x,
                 int incx, double beta, double *y, int incy);
float cblas_sdot(int n, const float *x, int incx, const float *y, int incy);
void cblas_saxpy(int n, float a, const float *x, int incx, float *y, int incy);
void cblas_sscal(int n, float alpha, float *x, int incx);
float cblas_snrm2(int n, const float *x, int incx);
void cblas_sgemv(CBLAS_ORDER order, CBLAS_TRANSPOSE trans, int m, int n,
                 float alpha, const float *a, int lda, const float *x,
                 int incx, float beta, float *y, int incy);
#endif
"""

BLAS_SHIM_C = r"""
#include "blasfuns.h"
#include <math.h>
double cblas_ddot(int n, const double *x, int incx, const double *y, int incy){
    double s = 0.0;
    for (int i = 0; i < n; i++) s += x[i*incx] * y[i*incy];
    return s;
}
void cblas_daxpy(int n, double a, const double *x, int incx, double *y, int incy){
    for (int i = 0; i < n; i++) y[i*incy] += a * x[i*incx];
}
void cblas_dscal(int n, double alpha, double *x, int incx){
    for (int i = 0; i < n; i++) x[i*incx] *= alpha;
}
double cblas_dnrm2(int n, const double *x, int incx){
    double s = 0.0;
    for (int i = 0; i < n; i++) s += x[i*incx] * x[i*incx];
    return sqrt(s);
}
void cblas_dgemv(CBLAS_ORDER order, CBLAS_TRANSPOSE trans, int m, int n,
                 double alpha, const double *a, int lda, const double *x,
                 int incx, double beta, double *y, int incy){
    /* row-major only, as used by the optimizer core.
       BLAS semantics: beta == 0 means y is write-only — it must NOT be
       read (the reference core passes uninitialized malloc'd buffers as
       y with beta=0, e.g. buffer_y in update_y_fisher,
       reference src/stochqn.c:936-952; computing 0*y there propagates
       NaN whenever the reused heap garbage is a NaN bit-pattern). */
    if (trans == CblasNoTrans) {
        for (int i = 0; i < m; i++) {
            double s = 0.0;
            for (int j = 0; j < n; j++) s += a[i*lda + j] * x[j*incx];
            y[i*incy] = alpha * s + (beta == 0.0 ? 0.0 : beta * y[i*incy]);
        }
    } else {
        if (beta == 0.0) for (int j = 0; j < n; j++) y[j*incy] = 0.0;
        else             for (int j = 0; j < n; j++) y[j*incy] *= beta;
        for (int i = 0; i < m; i++) {
            double s = alpha * x[i*incx];
            for (int j = 0; j < n; j++) y[j*incy] += s * a[i*lda + j];
        }
    }
}
float cblas_sdot(int n, const float *x, int incx, const float *y, int incy){
    float s = 0.0f;
    for (int i = 0; i < n; i++) s += x[i*incx] * y[i*incy];
    return s;
}
void cblas_saxpy(int n, float a, const float *x, int incx, float *y, int incy){
    for (int i = 0; i < n; i++) y[i*incy] += a * x[i*incx];
}
void cblas_sscal(int n, float alpha, float *x, int incx){
    for (int i = 0; i < n; i++) x[i*incx] *= alpha;
}
float cblas_snrm2(int n, const float *x, int incx){
    float s = 0.0f;
    for (int i = 0; i < n; i++) s += x[i*incx] * x[i*incx];
    return sqrtf(s);
}
void cblas_sgemv(CBLAS_ORDER order, CBLAS_TRANSPOSE trans, int m, int n,
                 float alpha, const float *a, int lda, const float *x,
                 int incx, float beta, float *y, int incy){
    /* same beta==0 write-only contract as cblas_dgemv above */
    if (trans == CblasNoTrans) {
        for (int i = 0; i < m; i++) {
            float s = 0.0f;
            for (int j = 0; j < n; j++) s += a[i*lda + j] * x[j*incx];
            y[i*incy] = alpha * s + (beta == 0.0f ? 0.0f : beta * y[i*incy]);
        }
    } else {
        if (beta == 0.0f) for (int j = 0; j < n; j++) y[j*incy] = 0.0f;
        else              for (int j = 0; j < n; j++) y[j*incy] *= beta;
        for (int i = 0; i < m; i++) {
            float s = alpha * x[i*incx];
            for (int j = 0; j < n; j++) y[j*incy] += s * a[i*lda + j];
        }
    }
}
"""


def compile_reference(build_dir: str, precision: str = "double") -> str:
    """Build the unmodified reference against the shim BLAS.

    ``precision``: "double" (-DUSE_DOUBLE, the reference's default
    instantiation) or "float" (-DUSE_FLOAT — the reference's dual-precision
    build, reference setup.py:51-58 / wrapper_float.pyx)."""
    if precision not in ("double", "float"):
        raise ValueError("precision must be 'double' or 'float'")
    with open(os.path.join(build_dir, "blasfuns.h"), "w") as f:
        f.write(BLASFUNS_H)
    with open(os.path.join(build_dir, "blas_shim.c"), "w") as f:
        f.write(BLAS_SHIM_C)
    so = os.path.join(build_dir, f"libstochqn_ref_{precision}.so")
    cmd = [
        "gcc", "-O3", "-march=native", "-std=c99", "-fPIC", "-shared",
        "-fopenmp", "-DUSE_DOUBLE" if precision == "double" else "-DUSE_FLOAT",
        f"-I{build_dir}", f"-I{REFERENCE}/include",
        f"{REFERENCE}/src/stochqn.c",
        os.path.join(build_dir, "blas_shim.c"),
        "-o", so, "-lm",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return so


def bind_reference(lib, precision: str = "double"):
    """Attach restype/argtypes for the reference C ABI (single source of
    truth — every harness that loads the reference uses this).  ``precision``
    must match the -DUSE_* flag the library was compiled with."""
    real = ctypes.c_double if precision == "double" else ctypes.c_float
    dp = ctypes.POINTER(real)
    lib.initialize_oLBFGS.restype = ctypes.c_void_p
    lib.initialize_oLBFGS.argtypes = [
        ctypes.c_int, ctypes.c_size_t, real, real,
        real, ctypes.c_int, ctypes.c_int]
    lib.run_oLBFGS.restype = ctypes.c_int
    lib.run_oLBFGS.argtypes = [
        real, dp, dp, ctypes.POINTER(dp),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.dealloc_oLBFGS.argtypes = [ctypes.c_void_p]

    lib.initialize_SQN.restype = ctypes.c_void_p
    lib.initialize_SQN.argtypes = [
        ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, real,
        ctypes.c_int, real, ctypes.c_int, ctypes.c_int]
    lib.run_SQN.restype = ctypes.c_int
    lib.run_SQN.argtypes = [
        real, dp, dp, dp, ctypes.POINTER(dp), ctypes.POINTER(dp),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.dealloc_SQN.argtypes = [ctypes.c_void_p]

    lib.initialize_adaQN.restype = ctypes.c_void_p
    lib.initialize_adaQN.argtypes = [
        ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        real, real, real, real,
        ctypes.c_int, real, ctypes.c_int, ctypes.c_int]
    # signature: run_adaQN(step, x, f, grad, &req, &task, ws, &info)
    lib.run_adaQN.restype = ctypes.c_int
    lib.run_adaQN.argtypes = [
        real, dp, real, dp, ctypes.POINTER(dp),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.dealloc_adaQN.argtypes = [ctypes.c_void_p]
    return lib


def multinomial_grad(w, X, Y, reg):
    """Weighted-mean multinomial logistic gradient, numpy/BLAS."""
    k = Y.shape[1]
    W = w.reshape(k, -1)
    coef, b = W[:, :-1], W[:, -1]
    z = X @ coef.T + b
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    diff = (p - Y) / X.shape[0]
    g_coef = diff.T @ X + reg * coef
    g = np.concatenate([g_coef, diff.sum(axis=0)[:, None]], axis=1)
    return g.reshape(-1)


def multinomial_hessvec(w, v, X, Y, reg):
    k = Y.shape[1]
    W = w.reshape(k, -1)
    coef, b = W[:, :-1], W[:, -1]
    V = v.reshape(k, -1)
    v_coef, v_b = V[:, :-1], V[:, -1]
    z = X @ coef.T + b
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    zv = X @ v_coef.T + v_b
    r = (p * (zv - (p * zv).sum(axis=1, keepdims=True))) / X.shape[0]
    h_coef = r.T @ X + reg * v_coef
    h = np.concatenate([h_coef, r.sum(axis=0)[:, None]], axis=1)
    return h.reshape(-1)


def measure(precision: str = "double") -> dict:
    """Measure the reference build at the given precision.  The float32
    measurement exists because bench.py's GPU path runs float32 — the
    like-for-like comparison is against the reference's own float32
    instantiation (which benefits from 2x SIMD width in numpy evals)."""
    build_dir = tempfile.mkdtemp(prefix="stochqn_ref_")
    so_path = compile_reference(build_dir, precision=precision)
    lib = bind_reference(ctypes.CDLL(so_path), precision=precision)
    npdt = np.float64 if precision == "double" else np.float32
    dp = ctypes.POINTER(
        ctypes.c_double if precision == "double" else ctypes.c_float)

    n = (N_FEATURES + 1) * N_CLASSES
    rng = np.random.default_rng(1)
    Xb = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES)) \
        .astype(npdt)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Yb = np.eye(N_CLASSES, dtype=npdt)[labels]
    x = rng.standard_normal(n).astype(npdt)

    ws = lib.initialize_SQN(n, 10, UPD_FREQ, 1e-4, 0, 0.0, 1, 4)
    assert ws

    grad = np.zeros(n, npdt)
    hess_vec = np.zeros(n, npdt)
    req = dp()
    req_vec = dp()
    task = ctypes.c_int(0)
    info = ctypes.c_int(0)

    CALC_GRAD, CALC_HESS_VEC = 101, 104

    def run(step):
        return lib.run_SQN(
            step, x.ctypes.data_as(dp), grad.ctypes.data_as(dp),
            hess_vec.ctypes.data_as(dp), ctypes.byref(req),
            ctypes.byref(req_vec), ctypes.byref(task), ws,
            ctypes.byref(info))

    def read_req(ptr):
        return np.ctypeslib.as_array(ptr, shape=(n,))

    run(STEP)   # first call -> requests gradient
    b = -1
    niter = 0
    target_iters = 2 * NUM_BATCHES
    t0 = time.perf_counter()
    while niter < target_iters:
        t = task.value
        if t == CALC_GRAD:
            b += 1
            i = b % NUM_BATCHES
            grad[:] = multinomial_grad(read_req(req), Xb[i], Yb[i], REG)
            niter += 1
        elif t == CALC_HESS_VEC:
            i = b % NUM_BATCHES
            idx = (i + 1 - UPD_FREQ + np.arange(UPD_FREQ)) % NUM_BATCHES
            Xl = Xb[idx].reshape(-1, N_FEATURES)
            Yl = Yb[idx].reshape(-1, N_CLASSES)
            hess_vec[:] = multinomial_hessvec(
                read_req(req), read_req(req_vec), Xl, Yl, REG)
        else:
            raise RuntimeError(f"unexpected task {t}")
        run(STEP)
    dt = time.perf_counter() - t0
    lib.dealloc_SQN(ws)

    key = ("reference_sqn_bibtex_iters_per_s" if precision == "double"
           else "reference_sqn_bibtex_iters_per_s_f32")
    return {
        key: round(target_iters / dt, 3),
        f"target_iters_{precision}": target_iters,
        f"seconds_{precision}": round(dt, 3),
    }


def main():
    if not os.path.isdir(REFERENCE):
        print(json.dumps({"skipped": "no reference checkout"}))
        return
    out = {}
    for precision in ("double", "float"):
        out.update(measure(precision))
    out["note"] = ("reference C core (both -DUSE_DOUBLE and -DUSE_FLOAT "
                   "builds, CPU, numpy gradient evals) on synthetic "
                   "BibTeX-shaped SQN workload; same shapes as bench.py. "
                   "bench.py compares its float32 GPU run against the "
                   "float32 reference build.")
    with open(os.path.join(REPO, "BASELINE_MEASURED.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
