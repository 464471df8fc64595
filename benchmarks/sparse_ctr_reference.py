"""Reference-C baseline for the sparse CTR workload (BASELINE config 5).

Compiles the unmodified reference C core (via the shim machinery in
``reference_baseline.py``) in float32 and drives ``run_SQN`` with
``use_grad_diff=1`` on the exact workload of ``sparse_ctr.py``: binary
logistic regression, 1M hashed features, 40 active per example, batch 512,
``mem_size=10``, ``bfgs_upd_freq=8``.  Gradients are evaluated with scipy
CSR products (the reference's own sparse story — its Python driver keeps
CSR matrices sparse end-to-end, ``stochqn/_optimizers.py:81-112``), so the
measurement is the honest end-to-end CPU number: sparse gradient + the
core's dense O(n) two-loop per iteration.

    python benchmarks/sparse_ctr_reference.py
"""
import ctypes
import importlib.util
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_FEATURES = 1_000_000
K_ACTIVE = 40
BATCH = 512
UPD_FREQ = 8
NUM_ROUNDS = 6
MEM = 10
STEP = 0.05
REPS = 5

CALC_GRAD, CALC_GRAD_BIG_BATCH = 101, 103


def make_batches(rng, n_batches):
    """CSR batches generated by the SAME sparse_ctr.make_round that feeds
    the on-device side — one generator, so the head-to-head stays locked to
    identical data layout (the rows are converted to CSR here because the
    reference consumes scipy matrices)."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "sparse_ctr", os.path.join(here, "sparse_ctr.py"))
    ctr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctr)
    out = []
    for _ in range(n_batches):
        idx, val, y = ctr.make_round(rng, BATCH)
        indptr = np.arange(BATCH + 1, dtype=np.int64) * K_ACTIVE
        X = sp.csr_matrix((val.ravel(), idx.ravel().astype(np.int64),
                           indptr), shape=(BATCH, N_FEATURES))
        out.append((X, y))
    return out


def binary_grad(w, X, y, reg):
    z = (X @ w) * y
    t = (1.0 / (1.0 + np.exp(-z)) - 1.0) * y            # sigmoid(z) - 1
    return (X.T @ t).astype(w.dtype) + reg * w


def main():
    from benchmarks._util import load_reference_baseline
    mod = load_reference_baseline()
    so = mod.compile_reference(tempfile.mkdtemp(prefix="ctr_ref_"),
                               precision="float")
    lib = mod.bind_reference(ctypes.CDLL(so), precision="float")
    fp = ctypes.POINTER(ctypes.c_float)

    rng = np.random.default_rng(0)
    nb = UPD_FREQ * NUM_ROUNDS
    batches = make_batches(rng, nb)

    x = np.zeros(N_FEATURES, np.float32)
    grad = np.zeros(N_FEATURES, np.float32)
    hess_vec = np.zeros(N_FEATURES, np.float32)
    req, req_vec = fp(), fp()
    task, info = ctypes.c_int(0), ctypes.c_int(0)

    ws = lib.initialize_SQN(N_FEATURES, MEM, UPD_FREQ, 1e-4, 1, 0.0, 1, 4)
    assert ws

    def run():
        return lib.run_SQN(
            STEP, x.ctypes.data_as(fp), grad.ctypes.data_as(fp),
            hess_vec.ctypes.data_as(fp), ctypes.byref(req),
            ctypes.byref(req_vec), ctypes.byref(task), ws,
            ctypes.byref(info))

    def read_req():
        return np.ctypeslib.as_array(req, shape=(N_FEATURES,))

    run()
    b = -1

    def drive(niters):
        nonlocal b
        done = 0
        while done < niters:
            t = task.value
            if t == CALC_GRAD:
                b += 1
                X, y = batches[b % nb]
                grad[:] = binary_grad(read_req(), X, y, 1e-6)
                done += 1
            elif t == CALC_GRAD_BIG_BATCH:
                idx = (b + 1 - UPD_FREQ + np.arange(UPD_FREQ)) % nb
                Xl = sp.vstack([batches[i][0] for i in idx], format="csr")
                yl = np.concatenate([batches[i][1] for i in idx])
                grad[:] = binary_grad(read_req(), Xl, yl, 1e-6)
            else:
                raise RuntimeError(f"unexpected task {t}")
            run()

    drive(UPD_FREQ)  # warmup through the first boundary
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        drive(nb)
        times.append(time.perf_counter() - t0)

    med = sorted(times)[len(times) // 2]
    lib.dealloc_SQN(ws)
    print(json.dumps({
        "benchmark": "sparse_ctr_reference",
        "mode": "reference-C-f32-cpu-4threads",
        "n_features": N_FEATURES,
        "k_active": K_ACTIVE,
        "batch": BATCH,
        "mem_size": MEM,
        "upd_freq": UPD_FREQ,
        "iters_per_s_median": round(nb / med, 2),
        "reps_iters_per_s": [round(nb / t, 2) for t in times],
    }))


if __name__ == "__main__":
    main()
