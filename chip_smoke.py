"""Smoke test of the library's main paths on one NVIDIA GPU.

    python chip_smoke.py [--seed N]        # one card: every phase below
    python chip_smoke.py --four-cards      # four cards: the sharded phase only

Phases (each one raises on failure; nothing is caught):

1. device    — JAX must report a GPU; the card's name and power limit.
2. fused     — ``FusedTrainer.jit_epochs`` for SQN, oLBFGS and adaQN on the
               BibTeX-shaped multinomial logistic regression (6,655 x 1,836
               features, 159 classes, n = 292,083, batch 50, m = 10,
               L = 20): the loss falls epoch by epoch, and the first 60
               iterations agree with the float64 NumPy oracle
               (``tests/oracle_numpy.py``) driven on the same batches.
3. two-loop  — ``two_loop_cached`` (classic and collapsed) against the
               oracle's sequential two-loop at n = 292,083 and 16,000,000,
               float32 and bfloat16 pair storage.
4. guided /  — ``StochasticLogisticRegression.fit`` for 2 epochs with each
   protocol    engine, and ``adaQN_free`` in lockstep with the oracle.
5. large n   — one donated SQN epoch at n = 16,000,000 with bf16 pairs.
6. four cards (``--four-cards`` only) — data-parallel SQN at the BibTeX
               shape and param-sharded bf16 SQN at n = 16,000,000, each
               against the same run on one card in this process.

The data are synthetic, drawn from ``--seed``.  The last line of standard
output is one JSON object: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oracle_numpy import (CALC_FUN_VAL_BATCH, CALC_GRAD,  # noqa: E402
                          CALC_GRAD_SAME_BATCH, CALC_HESS_VEC, AdaQNOracle,
                          OLBFGSOracle, SQNOracle, two_loop_np)
from stochqn_tpu.core.config import (AdaQNConfig, OLBFGSConfig,  # noqa: E402
                                     SQNConfig)
from stochqn_tpu.core.state import BFGSMemory  # noqa: E402
from stochqn_tpu.free import adaQN_free  # noqa: E402
from stochqn_tpu.fused import FusedTrainer  # noqa: E402
from stochqn_tpu.models import losses  # noqa: E402
from stochqn_tpu.models.logistic import StochasticLogisticRegression  # noqa
from stochqn_tpu.ops.pairs import commit_pair  # noqa: E402
from stochqn_tpu.ops.two_loop import two_loop_cached  # noqa: E402
from stochqn_tpu.parallel import make_mesh, shard_batches, shard_state  # noqa
from stochqn_tpu.utils import compile_cache  # noqa: E402
from stochqn_tpu.utils.metrics import gpu_name_and_power_limit  # noqa: E402

# The BibTeX job of the reference's notebook (example/example_stochqn.ipynb).
FEATURES, CLASSES, ROWS = 1836, 159, 6655
BATCH, MEM, UPD_FREQ = 50, 10, 20
REG = 1e-1
LARGE_N = 16_000_000

# Steps for the sum-over-batch loss of ``models.losses`` on these rows.
STEPS = {"SQN": 3e-2, "oLBFGS": 3e-2, "adaQN": 1e-1}
ORACLE_ITERS = 60           # three SQN / adaQN boundaries (L = 20)

# float32 on the card against float64 in NumPy.  The optimizer trajectory
# is compared under ``default_matmul_precision("highest")``; the two-loop
# alone at float32 and bfloat16 storage (bf16 rows are upcast inside the
# matmul at default precision, TF32 on this card).
TOL_X = 1e-4               # ||x - x_ref|| / ||x_ref|| after 60 iterations
TOL_LOSS = 1e-5            # |f(x) - f(x_ref)| / f(x_ref)
TOL_TWO_LOOP = {"float32": 1e-4, "bfloat16": 1e-2}
# Sharded against one card, same precision: the reduction order differs.
# With bf16 pair storage a changed last bit of a float32 sum can round a
# stored pair element the other way, so that cell gets more room.
TOL_FOUR_CARDS = {"float32": 1e-4, "bfloat16": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------------
# Data and the float64 NumPy references of the multinomial loss
# --------------------------------------------------------------------------
def make_problem(seed: int, features: int, classes: int, rows: int):
    """Planted multinomial problem: Gaussian rows of norm about 4, labels
    drawn from a random linear model.  Returns float32 ``X [rows, f]``,
    one-hot ``Y [rows, c]`` and ``x0 [c * (f + 1)]``."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((rows, features), dtype=np.float32)
         * np.float32(4.0 / math.sqrt(features)))
    w = rng.standard_normal((classes, features)) * 3.0
    logits = X @ w.T + rng.gumbel(size=(rows, classes))
    Y = np.eye(classes, dtype=np.float32)[np.argmax(logits, axis=1)]
    x0 = (rng.standard_normal(classes * (features + 1)) * 0.01).astype(
        np.float32)
    return X, Y, x0


def batched(a, batch: int):
    nb = a.shape[0] // batch
    return a[:nb * batch].reshape((nb, batch) + a.shape[1:])


def np_loss(x, X, Y, reg=REG):
    c = Y.shape[1]
    w = x.reshape(c, -1)
    z = X @ w[:, :-1].T + w[:, -1]
    z = z - z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return -np.sum(Y * logp) + 0.5 * reg * np.sum(w[:, :-1] ** 2)


def np_grad(x, X, Y, reg=REG):
    c = Y.shape[1]
    w = x.reshape(c, -1)
    z = X @ w[:, :-1].T + w[:, -1]
    p = np.exp(z - z.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    d = p - Y
    g = np.concatenate([d.T @ X + reg * w[:, :-1], d.sum(0)[:, None]], 1)
    return g.reshape(-1)


def np_hessvec(x, v, X, Y, reg=REG):
    c = Y.shape[1]
    w, vw = x.reshape(c, -1), v.reshape(c, -1)
    z = X @ w[:, :-1].T + w[:, -1]
    p = np.exp(z - z.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    zv = X @ vw[:, :-1].T + vw[:, -1]
    r = p * (zv - np.sum(p * zv, axis=1, keepdims=True))
    h = np.concatenate([r.T @ X + reg * vw[:, :-1], r.sum(0)[:, None]], 1)
    return h.reshape(-1)


def _grad_fn(x, batch):
    return losses.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _obj_fn(x, batch):
    return losses.multinomial_logistic_loss(x, batch[0], batch[1], None, REG)


def make_config(kind: str):
    if kind == "SQN":
        return SQNConfig.create(mem_size=MEM, bfgs_upd_freq=UPD_FREQ)
    if kind == "oLBFGS":
        return OLBFGSConfig.create(mem_size=MEM)
    return AdaQNConfig.create(mem_size=MEM, fisher_size=100,
                              bfgs_upd_freq=UPD_FREQ, max_incr=1.01)


def make_trainer(kind: str, **kw) -> FusedTrainer:
    return FusedTrainer(kind, make_config(kind), _grad_fn,
                        obj_fn=_obj_fn if kind == "adaQN" else None, **kw)


# --------------------------------------------------------------------------
# Phase 2: fused engine against the oracle
# --------------------------------------------------------------------------
def oracle_trajectory(kind: str, Xb, Yb, x0, step: float, iters: int):
    """Drive the float64 oracle through ``iters`` iterations on batches
    ``Xb[i], Yb[i]``, answering each request in NumPy.  Big-batch requests
    get the rows of the round that just ended (the fused engine's big
    batch)."""
    Xb = Xb.astype(np.float64)
    Yb = Yb.astype(np.float64)
    if kind == "SQN":
        orc = SQNOracle(mem_size=MEM, upd_freq=UPD_FREQ)
    elif kind == "oLBFGS":
        orc = OLBFGSOracle(mem_size=MEM)
    else:
        orc = AdaQNOracle(mem_size=MEM, fisher_size=100, upd_freq=UPD_FREQ,
                          max_incr=1.01)

    def big(it):
        lo = it - UPD_FREQ
        return (Xb[lo:it].reshape(-1, Xb.shape[-1]),
                Yb[lo:it].reshape(-1, Yb.shape[-1]))

    x = x0.astype(np.float64).copy()
    task, _, _ = orc.run(x, step)
    it = 0
    infos = []
    while True:
        if task == CALC_GRAD:
            if it == iters:
                break
            kw = dict(grad=np_grad(x, Xb[it], Yb[it]))
            it += 1
        elif task == CALC_GRAD_SAME_BATCH:
            kw = dict(grad=np_grad(x, Xb[it - 1], Yb[it - 1]))
        elif task == CALC_HESS_VEC:
            kw = dict(hess_vec=np_hessvec(orc.x_sum, orc.mem.s_pending,
                                          *big(it)))
        elif task == CALC_FUN_VAL_BATCH:
            at = orc.x_avg_prev if orc.section == 3 else orc.x_sum
            kw = dict(f=np_loss(at, *big(it)))
        else:
            raise AssertionError(f"unexpected oracle request {task}")
        task, info, _ = orc.run(x, step, **kw)
        infos.append(info)
    return x, infos


def fused_vs_oracle(kind: str, X, Y, x0, iters: int = ORACLE_ITERS,
                    precision: str = "highest"):
    """Run ``iters`` fused iterations (one ``jit_epochs`` dispatch) and the
    oracle on the same batches; returns ``(rel_x, rel_loss)``."""
    Xb, Yb = batched(X, BATCH)[:iters], batched(Y, BATCH)[:iters]
    step = STEPS[kind]
    trainer = make_trainer(kind)
    with jax.default_matmul_precision(precision):
        state, infos = trainer.jit_epochs()(
            trainer.init(jnp.asarray(x0)), (jnp.asarray(Xb), jnp.asarray(Yb)),
            jnp.float32(step), nepochs=1, aligned=True)
        x_dev = np.asarray(jax.block_until_ready(state.x))
    check(x_dev.dtype == np.float32 and x_dev.shape == x0.shape,
          f"{kind}: x has {x_dev.dtype} {x_dev.shape}")
    check(bool(np.all(np.isfinite(x_dev))), f"{kind}: non-finite iterate")
    x_ref, _ = oracle_trajectory(kind, Xb, Yb, x0, step, iters)
    rows = (Xb.reshape(-1, X.shape[1]).astype(np.float64),
            Yb.reshape(-1, Y.shape[1]).astype(np.float64))
    f_ref = np_loss(x_ref, *rows)
    rel_loss = abs(np_loss(x_dev.astype(np.float64), *rows) - f_ref) / abs(
        f_ref)
    return rel(x_dev, x_ref), float(rel_loss)


def fused_epochs(kind: str, X, Y, x0, epochs: int = 3):
    """``epochs`` full epochs through ``jit_epochs``; returns the loss over
    the data before and after each epoch."""
    Xd, Yd = jnp.asarray(batched(X, BATCH)), jnp.asarray(batched(Y, BATCH))
    nb = Xd.shape[0] - Xd.shape[0] % UPD_FREQ
    data = (Xd[:nb], Yd[:nb])
    trainer = make_trainer(kind, donate=True)
    run = trainer.jit_epochs()
    loss = jax.jit(lambda x: _obj_fn(x, (jnp.asarray(X), jnp.asarray(Y))))
    state = trainer.init(jnp.asarray(x0))
    trace = [float(loss(state.x))]
    for _ in range(epochs):
        state, _ = run(state, data, jnp.float32(STEPS[kind]), nepochs=1,
                       aligned=True)
        trace.append(float(loss(state.x)))
    return trace


def phase_fused(X, Y, x0) -> None:
    for kind in ("SQN", "oLBFGS", "adaQN"):
        t0 = time.perf_counter()
        trace = fused_epochs(kind, X, Y, x0)
        check(all(np.isfinite(trace)), f"{kind}: non-finite loss {trace}")
        check(all(b < a for a, b in zip(trace, trace[1:])),
              f"{kind}: loss did not fall every epoch {trace}")
        log(f"fused {kind}: loss by epoch {[round(v, 2) for v in trace]}")
        rx_tf32, rl_tf32 = fused_vs_oracle(kind, X, Y, x0,
                                           precision="default")
        log(f"fused {kind} vs oracle, default matmul precision: "
            f"rel_x={rx_tf32:.3e} rel_loss={rl_tf32:.3e} (not checked)")
        rx, rl = fused_vs_oracle(kind, X, Y, x0)
        log(f"fused {kind} vs oracle, highest precision, "
            f"{ORACLE_ITERS} iterations: rel_x={rx:.3e} (tol {TOL_X:g}) "
            f"rel_loss={rl:.3e} (tol {TOL_LOSS:g}) "
            f"[{time.perf_counter() - t0:.1f} s]")
        check(rx <= TOL_X and rl <= TOL_LOSS,
              f"{kind}: fused run is off the oracle")


# --------------------------------------------------------------------------
# Phase 3: the two-loop at real widths
# --------------------------------------------------------------------------
def phase_two_loop(seed: int, widths=(292_083, LARGE_N)) -> None:
    for n in widths:
        for storage in ("float32", "bfloat16"):
            errs = two_loop_errors(n, storage, seed)
            log(f"two-loop n={n} {storage} pairs: "
                + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                + f" (tol {TOL_TWO_LOOP[storage]:g})")
            check(max(errs.values()) <= TOL_TWO_LOOP[storage],
                  f"two-loop off the oracle at n={n} {storage}")


def synthetic_memory(n: int, storage: str, seed: int) -> BFGSMemory:
    """A full ``MEM``-pair memory committed through ``commit_pair`` (with
    the collapsed-direction cache): ``y = D s`` for a diagonal ``D`` in
    [0.5, 1.5], so every pair passes the curvature test."""
    st_t = jnp.bfloat16 if storage == "bfloat16" else None
    k_curv, k_s = jax.random.split(jax.random.PRNGKey(seed))
    curv = 0.5 + jax.random.uniform(k_curv, (n,), jnp.float32)
    mem = BFGSMemory.create(MEM, n, jnp.float32, st_t)
    commit = jax.jit(lambda mem, s, y: commit_pair(
        mem.replace(s_pending=s), y, 0.0, 0.0, direction_cache=True)[0])
    for i in range(MEM):
        s = jax.random.normal(jax.random.fold_in(k_s, i), (n,), jnp.float32)
        mem = commit(mem, s, curv * s)
    return mem


def two_loop_errors(n: int, storage: str, seed: int) -> dict:
    """Both cached two-loop forms against the sequential float64 two-loop
    on the pairs as stored; returns ``{form: rel_err}``."""
    mem = synthetic_memory(n, storage, seed)
    g = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,), jnp.float32)
    ds = {form: np.asarray(jax.jit(
        lambda g, mem, c=collapsed: two_loop_cached(g, mem, collapsed=c))(
            g, mem)) for form, collapsed in (("classic", False),
                                             ("collapsed", True))}
    # the oracle reads the pairs as stored (bf16-rounded when so stored),
    # oldest first: MEM commits into a MEM-slot ring fill it in order
    s64 = np.asarray(mem.s, np.float64)
    y64 = np.asarray(mem.y, np.float64)
    d_ref = two_loop_np(np.asarray(g, np.float64), list(zip(s64, y64)))
    return {form: rel(d, d_ref) for form, d in ds.items()}


# --------------------------------------------------------------------------
# Phase 4: guided driver and request protocol
# --------------------------------------------------------------------------
def guided_fit(X, Y, engine: str, epochs: int = 2):
    """Fit the model on one-hot ``Y`` in batches of about 50 rows (120 per
    epoch, a multiple of L); returns the flat ``[c, f + 1]`` weights and
    the model's own starting point."""
    model = StochasticLogisticRegression(
        reg_param=1e-4, optimizer="SQN", step_size=1e-1, engine=engine,
        random_state=1, nepochs=epochs, batches_per_epoch=120)
    model.fit(X, Y)
    coef = np.asarray(model.coef_, np.float64)
    b = np.asarray(model.intercept_, np.float64)
    x = np.concatenate([coef, b[:, None]], axis=1).reshape(-1)
    np.random.seed(1)                    # the model's initializer
    return x, np.random.normal(size=x.shape[0])


def phase_guided(X, Y) -> None:
    rows = (X.astype(np.float64), Y.astype(np.float64))
    for engine in ("protocol", "fused"):
        t0 = time.perf_counter()
        x, w0 = guided_fit(X, Y, engine)
        f0, f = np_loss(w0, *rows, 0.0), np_loss(x, *rows, 0.0)
        check(bool(np.all(np.isfinite(x))), f"guided {engine}: non-finite")
        check(f < f0, f"guided {engine}: loss {f} not below its start {f0}")
        log(f"guided SQN engine={engine}: 2 epochs, loss {f0:.1f} -> "
            f"{f:.1f} [{time.perf_counter() - t0:.1f} s]")


def protocol_vs_oracle(X, Y, x0, requests: int = 100):
    """``adaQN_free`` and the oracle in lockstep for ``requests`` requests:
    tasks and infos must agree; returns the final ``rel_x``."""
    Xb, Yb = batched(X, BATCH), batched(Y, BATCH)
    step = STEPS["adaQN"]
    opt = adaQN_free(mem_size=MEM, fisher_size=100, bfgs_upd_freq=UPD_FREQ,
                     max_incr=1.01, use_float=True)
    orc = AdaQNOracle(mem_size=MEM, fisher_size=100, upd_freq=UPD_FREQ,
                      max_incr=1.01)
    grad = jax.jit(_grad_fn)
    obj = jax.jit(_obj_fn)
    x_j = x0.astype(np.float32).copy()
    x_o = x0.astype(np.float64).copy()
    req = opt.run_optimizer(x_j, step)
    task_o, info_o, _ = orc.run(x_o, step)
    b = -1
    for k in range(requests):
        check(req["task"] == task_o, f"request {k}: task {req['task']} "
              f"!= oracle {task_o}")
        check(req["info"]["iteration_info"] == info_o,
              f"request {k}: info differs from the oracle")
        if task_o == CALC_GRAD:
            b = (b + 1) % Xb.shape[0]
            batch = (Xb[b], Yb[b])
            opt.update_gradient(np.asarray(grad(
                jnp.asarray(req["requested_on"]), batch)))
            kw = dict(grad=np_grad(x_o, Xb[b].astype(np.float64),
                                   Yb[b].astype(np.float64)))
        elif task_o == CALC_FUN_VAL_BATCH:
            lo = b + 1 - UPD_FREQ
            bigb = (Xb[lo:b + 1].reshape(-1, X.shape[1]),
                    Yb[lo:b + 1].reshape(-1, Y.shape[1]))
            opt.update_function(float(obj(jnp.asarray(req["requested_on"]),
                                          bigb)))
            at = orc.x_avg_prev if orc.section == 3 else orc.x_sum
            kw = dict(f=np_loss(at, *(a.astype(np.float64) for a in bigb)))
        else:
            raise AssertionError(f"unexpected request {task_o}")
        req = opt.run_optimizer(x_j, step)
        task_o, info_o, _ = orc.run(x_o, step, **kw)
    check(bool(np.all(np.isfinite(x_j))), "protocol: non-finite iterate")
    return rel(x_j, x_o)


def phase_protocol(X, Y, x0) -> None:
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        r = protocol_vs_oracle(X, Y, x0)
    log(f"protocol adaQN_free vs oracle, 100 requests: rel_x={r:.3e} "
        f"(tol {TOL_X:g}) [{time.perf_counter() - t0:.1f} s]")
    check(r <= TOL_X, "protocol run is off the oracle")


# --------------------------------------------------------------------------
# Phase 5: large n
# --------------------------------------------------------------------------
def quadratic(n: int):
    """Separable quadratic with a curvature ramp, synthesized from iota so
    no [n] constant is baked into the program (``benchmarks/large_n.py``).
    """
    def curv():
        return 0.5 + 1.5 * (jax.lax.iota(jnp.float32, n) / n)

    def grad_fn(x, batch):
        return curv() * (x - jnp.mean(batch))

    def value(x, t):
        return 0.5 * jnp.sum(curv() * (x - t) ** 2)
    return grad_fn, value


def large_n_epoch(n: int, place=None, seed: int = 0, batches: int = 40,
                  upd_freq: int = 8):
    """One donated SQN epoch with bf16 pairs on :func:`quadratic`;
    ``place(state, targets)`` may shard both first.  Returns the state and
    the objective before and after."""
    grad_fn, value = quadratic(n)
    rng = np.random.default_rng(seed)
    targets = jnp.asarray(rng.standard_normal((batches, 1)), jnp.float32)
    cfg = SQNConfig.create(mem_size=MEM, bfgs_upd_freq=upd_freq,
                           use_grad_diff=True, pairs_bf16=True)
    trainer = FusedTrainer("SQN", cfg, grad_fn, donate=True)
    x0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    state = trainer.init(x0)
    if place is not None:
        state, targets = place(state, targets)
    t = jnp.mean(targets)
    f0 = float(value(state.x, t))
    state, _ = trainer.jit_epoch()(state, targets, jnp.float32(1e-1),
                                   aligned=True)
    jax.block_until_ready(state.x)
    return state, f0, float(value(state.x, t))


def phase_large_n(n: int = LARGE_N) -> None:
    t0 = time.perf_counter()
    state, f0, f1 = large_n_epoch(n)
    check(np.isfinite(f1) and f1 < f0, f"large n: value {f0} -> {f1}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"large n={n} SQN bf16 pairs, donated epoch: value {f0:.4e} -> "
        f"{f1:.4e}, peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"[{time.perf_counter() - t0:.1f} s]")


# --------------------------------------------------------------------------
# Phase 6: four cards
# --------------------------------------------------------------------------
def on_all(tree, ndev: int, what: str) -> None:
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "sharding"):
            check(len(leaf.sharding.device_set) == ndev,
                  f"{what}: a leaf sits on {len(leaf.sharding.device_set)} "
                  f"of {ndev} devices")


def data_parallel_sqn(X, Y, x0, mesh=None, batch: int = 200,
                      epochs: int = 2):
    """SQN in batches of ``batch`` rows, on ``mesh`` (data axis) or on the
    default device; returns the final iterate."""
    Xd, Yd = jnp.asarray(batched(X, batch)), jnp.asarray(batched(Y, batch))
    nb = Xd.shape[0] - Xd.shape[0] % UPD_FREQ
    data = (Xd[:nb], Yd[:nb])
    trainer = make_trainer("SQN")
    state = trainer.init(jnp.asarray(x0))
    if mesh is not None:
        state = shard_state(state, mesh)
        data = shard_batches(data, mesh)
        on_all((state.x, data), mesh.size, "data-parallel SQN inputs")
    with jax.default_matmul_precision("highest"):
        state, _ = trainer.jit_epochs()(
            state, data, jnp.float32(STEPS["SQN"]), nepochs=epochs,
            aligned=True)
    if mesh is not None:
        on_all(state.x, mesh.size, "data-parallel SQN result")
    return np.asarray(state.x)


def phase_four_cards(X, Y, x0, n_large: int = LARGE_N) -> None:
    ndev = len(jax.devices())
    check(ndev >= 4, f"--four-cards needs 4 devices, JAX sees {ndev}")
    devs = jax.devices()[:4]

    t0 = time.perf_counter()
    x1 = data_parallel_sqn(X, Y, x0)
    x4 = data_parallel_sqn(X, Y, x0, mesh=make_mesh(n_data=4, devices=devs))
    r = rel(x4, x1)
    log(f"four cards: data-parallel SQN (mesh data=4, batch 200) vs one "
        f"card: rel_x={r:.3e} (tol {TOL_FOUR_CARDS['float32']:g}) "
        f"[{time.perf_counter() - t0:.1f} s]")
    check(r <= TOL_FOUR_CARDS["float32"],
          "data-parallel SQN is off the one-card run")

    t0 = time.perf_counter()
    st1, _, f1 = large_n_epoch(n_large)
    x_one = np.asarray(st1.x)
    del st1
    mesh = make_mesh(n_data=1, n_param=4, devices=devs)

    def place(state, targets):
        state = shard_state(state, mesh)
        on_all((state.x, state.mem.s, state.mem.y), 4, "param-sharded state")
        return state, jax.device_put(targets, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
    st4, _, f4 = large_n_epoch(n_large, place=place)
    on_all((st4.x, st4.mem.s, st4.mem.y), 4, "param-sharded state after "
           "the epoch")
    r = rel(np.asarray(st4.x), x_one)
    log(f"four cards: param-sharded SQN bf16 pairs n={n_large} (mesh "
        f"param=4) vs one card: rel_x={r:.3e} "
        f"(tol {TOL_FOUR_CARDS['bfloat16']:g}), value {f4:.4e} vs {f1:.4e} "
        f"[{time.perf_counter() - t0:.1f} s]")
    check(r <= TOL_FOUR_CARDS["bfloat16"],
          "param-sharded SQN is off the one-card run")


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    log(f"cache: {compile_cache.enable()}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"nvidia-smi: {gpu_name_and_power_limit()}")

    X, Y, x0 = make_problem(args.seed, FEATURES, CLASSES, ROWS)
    if args.four_cards:
        phase_four_cards(X, Y, x0)
    else:
        phase_fused(X, Y, x0)
        phase_two_loop(args.seed)
        phase_guided(X, Y)
        phase_protocol(X, Y, x0)
        phase_large_n()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
