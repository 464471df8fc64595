"""adaQN-on-MLP time-to-accuracy benchmark (BASELINE config 4).

Non-convex workload: a 784-256-10 ReLU MLP classifier (235k parameters) on
an MNIST-shaped synthetic dataset (16,384 train / 4,096 test; 10 Gaussian
clusters in 784-d, generated offline — see make_data).  adaQN runs with
its reference defaults: empirical-Fisher pair
source, RMSProp H0 (rmsprop_weight=0.9), ``max_incr`` function-value guard
— the configuration the reference aims at non-convex models
(``stochqn/_optimizers.py`` adaQN docstring).

Engines (one per process — one JAX process per card):

    python benchmarks/adaqn_mlp.py fused       # FusedTrainer on the GPU
    python benchmarks/adaqn_mlp.py protocol    # free-mode adaQN, jax-CPU core
    python benchmarks/adaqn_mlp.py reference   # unmodified reference C core

``protocol`` and ``reference`` use the *identical* jitted jax-CPU
gradient/objective closures, so their difference isolates the optimizer
core; ``fused`` is the on-device production path.  All engines share the
initial parameters and per-epoch batch schedule.  Timing covers training
only (eval paused); compile is warmed up before the clock starts.

Prints one JSON line: per-epoch (seconds, test accuracy) plus
``time_to_target_s`` at TARGET_ACC.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENGINE = sys.argv[1] if len(sys.argv) > 1 else "fused"
assert ENGINE in ("fused", "protocol", "reference"), ENGINE

if ENGINE != "fused":
    # pin the ISA so CPU cache entries are host-portable (same pin as
    # tests/conftest.py — mixed-ISA AOT entries mis-execute, CLAUDE.md)
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_max_isa=AVX2").strip()

import jax

if ENGINE != "fused":
    jax.config.update("jax_platforms", "cpu")
from stochqn_tpu.utils import compile_cache
compile_cache.enable()

import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from stochqn_tpu.models.mlp import init_mlp_params, mlp_logits, mlp_loss

SIZES = [784, 256, 10]
N_TRAIN, N_TEST = 16_384, 4_096
BATCH = 128
REG = 1e-4
STEP = 0.025
EPOCHS = 30
TARGET_ACC = 0.90
SEED = 7

ADAQN_KW = dict(mem_size=10, fisher_size=100, bfgs_upd_freq=20,
                max_incr=1.01, rmsprop_weight=0.9)
UPD_FREQ = ADAQN_KW["bfgs_upd_freq"]


def make_data():
    """10 Gaussian clusters in 784-d with ~5.9 sigma pairwise mean
    separation: Bayes accuracy ~0.99, so TARGET_ACC=0.90 is reachable but
    not instant — time-to-target discriminates between engines."""
    rng = np.random.default_rng(SEED)
    total = N_TRAIN + N_TEST
    y = rng.integers(0, SIZES[-1], total)
    means = rng.standard_normal((SIZES[-1], SIZES[0])).astype(np.float32)
    means *= 0.15
    X = means[y] + rng.standard_normal((total, SIZES[0])).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[y]
    return (X[:N_TRAIN], Y[:N_TRAIN], y[:N_TRAIN],
            X[N_TRAIN:], Y[N_TRAIN:], y[N_TRAIN:])


def epoch_order(epoch):
    return np.random.default_rng(1000 + epoch).permutation(N_TRAIN)


def flat_funs(unravel):
    """Flat-vector loss/grad closures shared by protocol and reference."""
    def loss_flat(xf, X, Y):
        return mlp_loss(unravel(xf), (X, Y), REG)
    grad_flat = jax.jit(jax.grad(loss_flat))
    loss_flat_j = jax.jit(loss_flat)
    return loss_flat_j, grad_flat


def test_acc(params, X_test, y_test):
    logits = mlp_logits(params, jnp.asarray(X_test))
    return float((np.asarray(jnp.argmax(logits, 1)) == y_test).mean())


def main():
    Xtr, Ytr, ytr, Xte, Yte, yte = make_data()
    params0 = init_mlp_params(jax.random.PRNGKey(3), SIZES, jnp.float32)
    x0, unravel = ravel_pytree(params0)
    n = x0.size
    nb = N_TRAIN // BATCH

    epochs_out = []   # (cumulative train seconds, test acc)

    if ENGINE == "fused":
        from stochqn_tpu.core.config import AdaQNConfig
        from stochqn_tpu.fused import batchify
        from stochqn_tpu.optax_adapter import PytreeTrainer

        trainer = PytreeTrainer(
            "adaQN", AdaQNConfig.create(**ADAQN_KW),
            lambda p, b: mlp_loss(p, b, REG), params0)
        epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
        Xj, Yj = jnp.asarray(Xtr), jnp.asarray(Ytr)

        def batched(epoch):
            idx = epoch_order(epoch)[: nb * BATCH]
            return batchify((Xj[idx], Yj[idx]), BATCH)

        # nb % UPD_FREQ != 0, so every epoch takes the generic layout
        # regardless of the aligned flag — pin it to ONE static value so
        # no retrace/compile can land inside a timed epoch (flipping it
        # after epoch 0 recompiled mid-benchmark).
        st = trainer.init(params0)   # compile warmup on a throwaway state
        st, _ = epoch_fn(st, batched(0), jnp.float32(STEP), aligned=False)
        jax.block_until_ready(st)

        state = trainer.init(params0)
        t = 0.0
        for ep in range(EPOCHS):
            data = batched(ep)
            t0 = time.perf_counter()
            state, _ = epoch_fn(state, data, jnp.float32(STEP),
                                aligned=False)
            jax.block_until_ready(state)
            t += time.perf_counter() - t0
            epochs_out.append((t, test_acc(trainer.params(state), Xte, yte)))

    elif ENGINE == "protocol":
        from stochqn_tpu.free import adaQN_free

        loss_j, grad_j = flat_funs(unravel)
        Xj, Yj = jnp.asarray(Xtr), jnp.asarray(Ytr)
        opt = adaQN_free(**ADAQN_KW)
        x = np.asarray(x0, np.float64)  # driver keeps float64 view; core f32

        def big(b_idx, order):
            # cyclic window over the CURRENT epoch's permutation — the
            # same semantics as the fused engine's generic path
            # (fused._cyclic_window) and the reference driver's
            # "larger continuous sample" shortcut
            # (stochqn/_optimizers.py:66-69), so all engines see
            # equivalent boundary windows.
            sel = order[[(b_idx - UPD_FREQ + 1 + k) % nb
                         for k in range(UPD_FREQ)]].reshape(-1)
            return Xj[sel], Yj[sel]

        # warm the jit on one batch / big-batch shape
        o = epoch_order(0).reshape(nb, BATCH)
        grad_j(x0, Xj[o[0]], Yj[o[0]]).block_until_ready()
        grad_j(x0, *big(UPD_FREQ - 1, o)).block_until_ready()
        loss_j(x0, *big(UPD_FREQ - 1, o)).block_until_ready()

        t, b = 0.0, -1
        req = opt.run_optimizer(x, STEP)
        for ep in range(EPOCHS):
            order = epoch_order(ep).reshape(nb, BATCH)
            t0 = time.perf_counter()
            done = 0
            while done < nb:
                xq = jnp.asarray(req["requested_on"], jnp.float32)
                task = req["task"]
                if task == "calc_grad":
                    b += 1
                    done += 1
                    i = order[b % nb]
                    opt.update_gradient(grad_j(xq, Xj[i], Yj[i]))
                elif task == "calc_grad_big_batch":
                    opt.update_gradient(grad_j(xq, *big(b % nb, order)))
                elif task == "calc_fun_val_batch":
                    opt.update_function(loss_j(xq, *big(b % nb, order)))
                else:
                    raise RuntimeError(task)
                req = opt.run_optimizer(x, STEP)
            t += time.perf_counter() - t0
            epochs_out.append(
                (t, test_acc(unravel(jnp.asarray(x, jnp.float32)), Xte, yte)))

    else:  # reference
        import ctypes
        import importlib.util
        import tempfile

        from benchmarks._util import load_reference_baseline
        mod = load_reference_baseline()
        so = mod.compile_reference(tempfile.mkdtemp(prefix="mlp_ref_"),
                                   precision="float")
        lib = mod.bind_reference(ctypes.CDLL(so), precision="float")
        fpt = ctypes.POINTER(ctypes.c_float)

        loss_j, grad_j = flat_funs(unravel)
        Xj, Yj = jnp.asarray(Xtr), jnp.asarray(Ytr)

        def big(b_idx, order):
            sel = order[[(b_idx - UPD_FREQ + 1 + k) % nb
                         for k in range(UPD_FREQ)]].reshape(-1)
            return Xj[sel], Yj[sel]

        o = epoch_order(0).reshape(nb, BATCH)
        grad_j(x0, Xj[o[0]], Yj[o[0]]).block_until_ready()
        grad_j(x0, *big(UPD_FREQ - 1, o)).block_until_ready()
        loss_j(x0, *big(UPD_FREQ - 1, o)).block_until_ready()

        # initialize_adaQN(n, mem, fisher, upd_freq, max_incr, min_curv,
        #                  scal_reg, rmsprop_weight, use_grad_diff, y_reg,
        #                  check_nan, nthreads)   [stochqn.h:235-237]
        ws = lib.initialize_adaQN(
            n, ADAQN_KW["mem_size"], ADAQN_KW["fisher_size"], UPD_FREQ,
            ADAQN_KW["max_incr"], 1e-4, 1e-4, ADAQN_KW["rmsprop_weight"],
            0, 0.0, 1, 4)
        assert ws

        x = np.asarray(x0, np.float32).copy()
        grad = np.zeros(n, np.float32)
        fval = 0.0
        req = fpt()
        task, info = ctypes.c_int(0), ctypes.c_int(0)
        CALC_GRAD, CALC_FUN_VAL_BATCH = 101, 105

        def run():
            return lib.run_adaQN(
                STEP, x.ctypes.data_as(fpt), ctypes.c_float(fval),
                grad.ctypes.data_as(fpt), ctypes.byref(req),
                ctypes.byref(task), ws, ctypes.byref(info))

        def read_req():
            return np.ctypeslib.as_array(req, shape=(n,))

        run()
        t, b = 0.0, -1
        for ep in range(EPOCHS):
            order = epoch_order(ep).reshape(nb, BATCH)
            t0 = time.perf_counter()
            done = 0
            while done < nb:
                xq = jnp.asarray(read_req())
                if task.value == CALC_GRAD:
                    b += 1
                    done += 1
                    i = order[b % nb]
                    grad[:] = np.asarray(grad_j(xq, Xj[i], Yj[i]))
                elif task.value == CALC_FUN_VAL_BATCH:
                    fval = float(loss_j(xq, *big(b % nb, order)))
                else:
                    raise RuntimeError(f"task {task.value}")
                run()
            t += time.perf_counter() - t0
            epochs_out.append(
                (t, test_acc(unravel(jnp.asarray(x)), Xte, yte)))
        lib.dealloc_adaQN(ws)

    tt = next((round(s, 3) for s, a in epochs_out if a >= TARGET_ACC), None)
    print(json.dumps({
        "benchmark": "adaqn_mlp",
        "engine": ENGINE,
        "device": jax.devices()[0].device_kind,
        "n_params": int(n),
        "epochs": [[round(s, 3), round(a, 4)] for s, a in epochs_out],
        "target_acc": TARGET_ACC,
        "time_to_target_s": tt,
        "final_acc": round(epochs_out[-1][1], 4),
        "train_s_total": round(epochs_out[-1][0], 3),
    }))


if __name__ == "__main__":
    main()
