"""BASELINE config 1: oLBFGS binary logistic regression on sklearn digits.

The reference README's Mode-1 example (`README.md:95-130`:
``StochasticLogisticRegression`` / oLBFGS fed batches via ``partial_fit``).
Head-to-head on the identical workload — digits (1,797 x 64), binary task
``target >= 5``, batch 100, oLBFGS mem 10, constant step, same float32
precision and the same mean-gradient convention on every engine:

  * ``reference``: the unmodified reference C core (``-DUSE_FLOAT`` build,
    compiled from /root/reference by benchmarks/reference_baseline.py)
    driven through its free-mode protocol with numpy/BLAS gradients.
  * ``native``: this framework's C++17 tier (same protocol, same numpy
    gradients) — the CPU-vs-CPU optimizer comparison.
  * ``fused``: the on-device engine — whole epochs as one jitted
    ``lax.scan`` with on-device gradients (the framework's intended
    deployment mode).

Metrics: end-to-end optimizer iterations/s (median of N_REPS timed blocks
of EPOCHS_PER_REP epochs; ``block_until_ready`` per rep), final train
accuracy, and wall-clock to 0.85 train
accuracy (epochs-to-target discovered untimed, then exactly those epochs
timed back-to-back, the same shape as benchmarks/time_to_target.py).

Run:  python benchmarks/digits_olbfgs.py [--skip-fused]
"""
import argparse
import ctypes
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from benchmarks.reference_baseline import compile_reference, bind_reference

BATCH = 100
NUM_BATCHES = 17          # 1,700 of the 1,797 rows per epoch
MEM = 10
STEP = 1.0
REG = 1e-3
EPOCHS_PER_REP = 5
N_REPS = 5
TARGET_ACC = 0.85

TASK_CALC_GRAD = 101

_REF_LIB = None


def _ref_lib():
    global _REF_LIB
    if _REF_LIB is None:
        so = compile_reference(tempfile.mkdtemp(prefix="sqn_ref_digits_"),
                               "float")
        _REF_LIB = bind_reference(ctypes.CDLL(so), "float")
    return _REF_LIB


def load_digits_binary():
    from sklearn.datasets import load_digits
    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = (d.target >= 5).astype(np.float32)
    n = NUM_BATCHES * BATCH
    return X[:n], y[:n]


def np_grad(w, X, y, reg=REG):
    """Mean binary-logistic gradient, numpy/BLAS — same closed form as
    stochqn_tpu.models.losses.binary_logistic_grad with sw = 1/B."""
    coef, b = w[:-1], w[-1]
    ys = np.where(y > 0, 1.0, -1.0).astype(w.dtype)
    z = (X @ coef + b) * ys
    t = (1.0 / (1.0 + np.exp(-z)) - 1.0) * ys / X.shape[0]
    g_coef = t @ X + reg * coef
    return np.concatenate([g_coef, [t.sum()]]).astype(w.dtype)


def accuracy(w, X, y):
    p = X @ w[:-1] + w[-1]
    return float(((p > 0) == (y > 0)).mean())


# --------------------------------------------------------------------------
# protocol engines (reference C / our C++ tier), identical drive loop
# --------------------------------------------------------------------------

class RefOLBFGS:
    """Free-mode loop over the unmodified reference C core (float32)."""

    def __init__(self, n, x0):
        self.lib = _ref_lib()
        self.real = ctypes.c_float
        self.n = n
        self.ws = self.lib.initialize_oLBFGS(
            n, MEM, self.real(0.0), self.real(0.0), self.real(1e-4), 1, 1)
        if not self.ws:
            raise RuntimeError("reference allocation failed")
        self.x = np.array(x0, np.float32)
        self.grad = np.zeros(n, np.float32)
        self.pending = self._run()      # initial calc_grad request

    def _run(self):
        req = ctypes.POINTER(self.real)()
        task = ctypes.c_int(0)
        info = ctypes.c_int(0)
        self.lib.run_oLBFGS(
            self.real(STEP),
            self.x.ctypes.data_as(ctypes.POINTER(self.real)),
            self.grad.ctypes.data_as(ctypes.POINTER(self.real)),
            ctypes.byref(req), ctypes.byref(task), self.ws,
            ctypes.byref(info))
        return task.value, np.ctypeslib.as_array(req, (self.n,))

    def close(self):
        if self.ws:
            self.lib.dealloc_oLBFGS(self.ws)
            self.ws = None


class NativeOLBFGSLoop:
    """Same loop over this framework's C++17 tier."""

    def __init__(self, n, x0):
        from stochqn_tpu.native_backend import NativeOLBFGS
        self.opt = NativeOLBFGS(mem_size=MEM, dtype=np.float32)
        self.opt.start(np.asarray(x0, np.float32))
        self.x = self.opt.x
        self.grad = self.opt.gradient
        self.pending = self._run()

    def _run(self):
        task, info, changed, req, _ = self.opt.run(STEP)
        return task, req

    def close(self):
        pass


def drive_protocol(engine, X, y, epochs):
    """Run `epochs` passes; one oLBFGS iteration per batch (minibatch grad
    + same-batch grad), like the guided partial_fit driver."""
    for _ in range(epochs):
        for b in range(NUM_BATCHES):
            Xb = X[b * BATCH:(b + 1) * BATCH]
            yb = y[b * BATCH:(b + 1) * BATCH]
            while True:
                task, req = engine.pending
                engine.grad[:] = np_grad(req, Xb, yb)
                engine.pending = engine._run()
                if engine.pending[0] == TASK_CALC_GRAD:
                    break


def _timed_rep(make_engine, X, y, x0):
    engine = make_engine(x0.shape[0], x0)
    t0 = time.perf_counter()
    drive_protocol(engine, X, y, EPOCHS_PER_REP)
    dt = time.perf_counter() - t0
    acc = accuracy(engine.x, X, y)
    engine.close()
    return EPOCHS_PER_REP * NUM_BATCHES / dt, acc


def measure_protocols(engines, X, y, x0):
    """Measure all protocol engines with INTERLEAVED repetitions: timing
    one engine's reps back-to-back and then the other's hands whichever
    runs first/last a different host state (CPU frequency, cache, ambient
    load) — observed as a spurious ~2x swing on this machine.  Rep k of
    every engine runs adjacent in time instead."""
    n = x0.shape[0]
    for name, mk in engines:            # warmup (BLAS/thread spinup)
        eng = mk(n, x0)
        drive_protocol(eng, X, y, 1)
        eng.close()
    reps = {name: [] for name, _ in engines}
    accs = {}
    for _ in range(N_REPS):
        for name, mk in engines:
            ips, acc = _timed_rep(mk, X, y, x0)
            reps[name].append(ips)
            accs[name] = acc

    rows = []
    for name, mk in engines:
        # time-to-target: discover epochs needed (untimed), then time
        engine = mk(n, x0)
        epochs_needed = 0
        for _ in range(50):
            drive_protocol(engine, X, y, 1)
            epochs_needed += 1
            if accuracy(engine.x, X, y) >= TARGET_ACC:
                break
        engine.close()
        engine = mk(n, x0)
        t0 = time.perf_counter()
        drive_protocol(engine, X, y, epochs_needed)
        ttt = time.perf_counter() - t0
        assert accuracy(engine.x, X, y) >= TARGET_ACC
        engine.close()
        rows.append({
            "engine": name,
            "iters_per_s": round(statistics.median(reps[name]), 1),
            "reps": [round(r, 1) for r in reps[name]],
            "final_acc": round(accs[name], 4),
            "epochs_to_target": epochs_needed,
            "s_to_target": round(ttt, 4)})
    return rows


# --------------------------------------------------------------------------
# fused on-device engine
# --------------------------------------------------------------------------

def measure_fused(X, y, x0):
    import jax
    from stochqn_tpu.utils import compile_cache
    compile_cache.enable()
    import jax.numpy as jnp
    from stochqn_tpu.core.config import OLBFGSConfig
    from stochqn_tpu.fused import FusedTrainer
    from stochqn_tpu.models import losses

    Xb = jnp.asarray(X.reshape(NUM_BATCHES, BATCH, -1))
    yb = jnp.asarray(y.reshape(NUM_BATCHES, BATCH))
    sw = jnp.full((BATCH,), 1.0 / BATCH, jnp.float32)

    def grad_fn(w, batch):
        Xi, yi = batch
        return losses.binary_logistic_grad(w, Xi, yi, sw, REG)

    trainer = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=MEM),
                           grad_fn)
    epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
    eta = jnp.float32(STEP)

    def run_epochs(state, k):
        for _ in range(k):
            state, _ = epoch_fn(state, (Xb, yb), eta, aligned=True)
        return state

    state = run_epochs(trainer.init(jnp.asarray(x0)), 2)  # compile+warm
    float(jnp.sum(state.x))
    reps = []
    for _ in range(N_REPS):
        t0 = time.perf_counter()
        state = run_epochs(state, EPOCHS_PER_REP)
        checksum = float(jnp.sum(state.x))   # D2H barrier
        dt = time.perf_counter() - t0
        if checksum != checksum:
            raise RuntimeError("NaN iterate")
        reps.append(EPOCHS_PER_REP * NUM_BATCHES / dt)
    acc = accuracy(np.asarray(state.x), X, y)

    # time-to-target, same discovery/timing split as the protocol engines
    state = trainer.init(jnp.asarray(x0))
    epochs_needed = 0
    for _ in range(50):
        state = run_epochs(state, 1)
        epochs_needed += 1
        if accuracy(np.asarray(state.x), X, y) >= TARGET_ACC:
            break
    state = trainer.init(jnp.asarray(x0))
    float(jnp.sum(state.x))
    t0 = time.perf_counter()
    state = run_epochs(state, epochs_needed)
    float(jnp.sum(state.x))
    ttt = time.perf_counter() - t0
    assert accuracy(np.asarray(state.x), X, y) >= TARGET_ACC
    return {"engine": "fused (%s)" % jax.devices()[0].device_kind,
            "iters_per_s": round(statistics.median(reps), 1),
            "reps": [round(r, 1) for r in reps],
            "final_acc": round(acc, 4),
            "epochs_to_target": epochs_needed,
            "s_to_target": round(ttt, 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-fused", action="store_true")
    args = ap.parse_args()

    X, y = load_digits_binary()
    rng = np.random.default_rng(1)
    x0 = (rng.standard_normal(X.shape[1] + 1) * 0.1).astype(np.float32)

    rows = measure_protocols(
        [("reference C (f32)", RefOLBFGS),
         ("native C++ (f32)", NativeOLBFGSLoop)], X, y, x0)
    if not args.skip_fused:
        rows.append(measure_fused(X, y, x0))
    print(json.dumps({"workload": "digits binary oLBFGS (BASELINE config 1)",
                      "batch": BATCH, "num_batches": NUM_BATCHES,
                      "mem": MEM, "step": STEP, "target_acc": TARGET_ACC,
                      "results": rows}, indent=1))


if __name__ == "__main__":
    main()
