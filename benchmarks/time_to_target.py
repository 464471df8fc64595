"""Time-to-target-loss: reference C core vs stochqn_tpu fused engine.

BASELINE.json's headline metric.  Both engines run SQN on the identical
synthetic BibTeX-shaped multinomial-logistic problem (same seed, same batch
schedule, same hyperparameters); the target is the full-data loss the
reference reaches after two epochs.  We report the wall-clock each engine
needs to reach that loss (steady-state: compile time excluded and noted
separately).

    python benchmarks/time_to_target.py
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"

N_FEATURES = 1836
N_CLASSES = 159
BATCH_SIZE = 50
NUM_BATCHES = 120
UPD_FREQ = 20
REG = 1e-1
STEP = 1e-2
REF_EPOCHS = 2


def _load_refmod():
    from benchmarks._util import load_reference_baseline
    return load_reference_baseline()


def _data():
    rng = np.random.default_rng(1)
    Xb = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES))
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Yb = np.eye(N_CLASSES)[labels]
    x0 = rng.standard_normal((N_FEATURES + 1) * N_CLASSES)
    return Xb, Yb, x0


def full_loss(w, Xb, Yb):
    X = Xb.reshape(-1, N_FEATURES)
    Y = Yb.reshape(-1, N_CLASSES)
    k = Y.shape[1]
    W = w.reshape(k, -1)
    coef, b = W[:, :-1], W[:, -1]
    z = X @ coef.T + b
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    loss = -(Y * logp).sum() / X.shape[0]
    return loss + 0.5 * REG * (coef ** 2).sum()


def run_reference(mod, Xb, Yb, x0):
    """Returns (loss_after_REF_EPOCHS, seconds)."""
    build = tempfile.mkdtemp(prefix="stochqn_ttt_")
    lib = mod.bind_reference(ctypes.CDLL(mod.compile_reference(build)))
    dp = ctypes.POINTER(ctypes.c_double)
    n = x0.shape[0]
    x = x0.copy()
    ws = lib.initialize_SQN(n, 10, UPD_FREQ, 1e-4, 0, 0.0, 1, 4)
    grad = np.zeros(n)
    hv = np.zeros(n)
    req, reqv = dp(), dp()
    task, info = ctypes.c_int(0), ctypes.c_int(0)

    def run():
        lib.run_SQN(STEP, x.ctypes.data_as(dp), grad.ctypes.data_as(dp),
                    hv.ctypes.data_as(dp), ctypes.byref(req),
                    ctypes.byref(reqv), ctypes.byref(task), ws,
                    ctypes.byref(info))

    run()
    b = -1
    niter = 0
    t0 = time.perf_counter()
    while niter < REF_EPOCHS * NUM_BATCHES:
        if task.value == 101:
            b += 1
            i = b % NUM_BATCHES
            grad[:] = mod.multinomial_grad(
                np.ctypeslib.as_array(req, shape=(n,)), Xb[i], Yb[i], REG)
            niter += 1
        elif task.value == 104:
            i = b % NUM_BATCHES
            idx = (i + 1 - UPD_FREQ + np.arange(UPD_FREQ)) % NUM_BATCHES
            hv[:] = mod.multinomial_hessvec(
                np.ctypeslib.as_array(req, shape=(n,)),
                np.ctypeslib.as_array(reqv, shape=(n,)),
                Xb[idx].reshape(-1, N_FEATURES),
                Yb[idx].reshape(-1, N_CLASSES), REG)
        run()
    dt = time.perf_counter() - t0
    return full_loss(x, Xb, Yb), dt


def run_ours(Xb, Yb, x0, target):
    import jax
    from stochqn_tpu.utils import compile_cache
    compile_cache.enable()
    import jax.numpy as jnp
    from stochqn_tpu.core.config import SQNConfig
    from stochqn_tpu.fused import FusedTrainer
    from stochqn_tpu.models import losses

    X = jnp.asarray(Xb, jnp.float32)
    Y = jnp.asarray(Yb, jnp.float32)

    def grad_fn(x, batch):
        # mean (not sum) gradient, matching the reference evaluation
        Xc, Yc = batch
        sw = jnp.full((Xc.shape[0],), 1.0 / Xc.shape[0], jnp.float32)
        return losses.multinomial_logistic_grad(x, Xc, Yc, sw, REG)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=UPD_FREQ),
        grad_fn)
    state = trainer.init(jnp.asarray(x0, jnp.float32))
    epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))

    Xflat = jnp.asarray(Xb.reshape(-1, N_FEATURES), jnp.float32)
    Yflat = jnp.asarray(Yb.reshape(-1, N_CLASSES), jnp.float32)

    # compile (excluded from timing, reported separately)
    t0 = time.perf_counter()
    warm_state, _ = epoch_fn(state, (X, Y), jnp.float32(STEP),
                             aligned=True)
    jax.block_until_ready(warm_state)
    compile_s = time.perf_counter() - t0

    n_total = NUM_BATCHES * BATCH_SIZE
    sw_full = jnp.full((n_total,), 1.0 / n_total, jnp.float32)
    loss_fn = jax.jit(lambda x: losses.multinomial_logistic_loss(
        x, Xflat, Yflat, sw_full, REG))
    float(loss_fn(warm_state.x))  # compile the loss eval too

    # Phase 1 (untimed): discover how many epochs reach the target.  The
    # per-epoch loss check costs a blocking host round trip and the
    # reference's timed region contains no equivalent check, so it must
    # not be on the clock.
    state = trainer.init(jnp.asarray(x0, jnp.float32))
    epochs = 0
    loss = float("inf")
    while epochs < 50:
        state, _ = epoch_fn(state, (X, Y), jnp.float32(STEP),
                            aligned=True)
        epochs += 1
        loss = float(loss_fn(state.x))
        if loss <= target:
            break

    # Phase 2 (timed): exactly the discovered number of epochs from the
    # same initial state, dispatched back to back with ONE terminal
    # barrier — the same shape as the reference's timed region (its 2
    # epochs run check-free).
    state = trainer.init(jnp.asarray(x0, jnp.float32))
    t0 = time.perf_counter()
    for _ in range(epochs):
        state, _ = epoch_fn(state, (X, Y), jnp.float32(STEP),
                            aligned=True)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(state.x))):
        raise RuntimeError("NaN iterate")

    # Phase 3: marginal per-epoch DEVICE time (chain differencing).
    # `dt` above pays the fixed cost of one dispatch chain; epochs *
    # marginal is the device-only time-to-target, reported alongside.
    def chain(st, k):
        for _ in range(k):
            st, _ = epoch_fn(st, (X, Y), jnp.float32(STEP), aligned=True)
        float(jnp.sum(st.x))
        return st
    st = chain(state, 2)
    reps = []
    for _ in range(3):
        t0 = time.perf_counter(); st = chain(st, 2)
        t1 = time.perf_counter(); st = chain(st, 12)
        t2 = time.perf_counter()
        reps.append(((t2 - t1) - (t1 - t0)) / 10)
    marginal = sorted(reps)[1]
    return loss, dt, epochs, compile_s, marginal * epochs


def main():
    mod = _load_refmod()
    Xb, Yb, x0 = _data()
    ref_loss, ref_s = run_reference(mod, Xb, Yb, x0)
    print(f"reference: loss {ref_loss:.4f} after {REF_EPOCHS} epochs "
          f"in {ref_s:.2f}s", flush=True)
    our_loss, our_s, epochs, compile_s, dev_s = run_ours(Xb, Yb, x0,
                                                         ref_loss)
    reached = bool(our_loss <= ref_loss)
    out = {
        "target_loss": round(float(ref_loss), 4),
        "reference_seconds": round(ref_s, 3),
        "ours_seconds": round(our_s, 4),
        "ours_seconds_device": round(dev_s, 4),
        "ours_epochs": epochs,
        "ours_final_loss": round(float(our_loss), 4),
        "ours_compile_seconds": round(compile_s, 2),
        "target_reached": reached,
        "speedup": round(ref_s / our_s, 1) if reached else None,
        "speedup_device": round(ref_s / dev_s, 1) if reached else None,
        "note": ("ours_seconds includes the fixed cost of one dispatch "
                 "chain; _device is the chain-differenced marginal"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
