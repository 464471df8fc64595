"""Dispatch-granularity A/B on the flagship workload.

Three regimes, all interleaved rep-by-rep (sequential per-engine timing
hands the engines different host states):

1. ``async``     — per-epoch dispatches, ONE terminal barrier per
                   20-epoch rep (the bench loop's shape) vs the same
                   20 epochs as one ``jit_epochs`` program.
2. ``sync``      — per-epoch dispatches with a BLOCKING ``np.asarray
                   (infos)`` after every epoch (the guided driver's
                   shape) vs one program: each epoch exposes a full host
                   round trip.
3. ``scheduled`` — per-epoch host reshuffle + re-upload + blocking read
                   vs ``jit_epochs_scheduled`` (dataset uploaded once,
                   composed row orders gathered on device).

Not yet run on the H100.  Reference context: the reference's guided
driver reshuffles and re-batches on the host every epoch
(``stochqn/_optimizers.py:251-256``) — free on a CPU optimizer, a
per-epoch host-to-device tax on an accelerator.
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer, batchify
from stochqn_tpu.models import losses

NF, NC, BS, NB, L, M = 1836, 159, 50, 120, 20, 10
N = NB * BS
E = 20          # epochs per rep
REPS = 5


def make_trainer(grad_fn):
    return FusedTrainer("SQN", SQNConfig.create(mem_size=M,
                                                bfgs_upd_freq=L), grad_fn)


def main():
    rng = np.random.default_rng(1)
    Xf = rng.standard_normal((N, NF)).astype(np.float32)
    lab = rng.integers(0, NC, N)
    Yf = np.eye(NC, dtype=np.float32)[lab]
    x0 = jnp.asarray(rng.standard_normal((NF + 1) * NC), jnp.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)

    Xd, Yd = jnp.asarray(Xf), jnp.asarray(Yf)
    data = batchify((Xd, Yd), BS)
    eta = jnp.float32(1e-2)

    def mk_schedule():
        cur = np.arange(N)
        orders = np.empty((E, N), np.int32)
        steps = np.empty(E, np.float64)
        for e in range(E):
            np.random.seed(1 + e)
            cur = cur[np.argsort(np.random.random(size=N))]
            orders[e] = cur
            steps[e] = 1e-2 / np.sqrt(e + 1)
        return orders, steps

    # one trainer per engine so states evolve independently
    tr = {k: make_trainer(grad_fn) for k in
          ("async_loop", "async_one", "sync_loop", "sync_one",
           "sched_loop", "sched_one")}
    st = {k: t.init(x0) for k, t in tr.items()}
    ep = {k: t.jit_epoch() for k, t in tr.items()}
    one = {k: t.jit_epochs() for k, t in tr.items()}
    sched = tr["sched_one"].jit_epochs_scheduled()

    # warm every program
    for k in ("async_loop", "sync_loop", "sched_loop"):
        st[k], i = ep[k](st[k], data, eta, aligned=True)
        np.asarray(i)
    for k in ("async_one", "sync_one"):
        st[k], i = one[k](st[k], data, eta, nepochs=E, aligned=True)
        np.asarray(i)
    o_np, s_np = mk_schedule()
    st["sched_one"], i = sched(st["sched_one"], (Xd, Yd),
                               jnp.asarray(s_np, jnp.float32),
                               jnp.asarray(o_np), batch_size=BS,
                               aligned=True)
    np.asarray(i)

    out = {k: [] for k in tr}
    for _ in range(REPS):
        # 1a. async per-epoch
        t0 = time.perf_counter()
        for _ in range(E):
            st["async_loop"], _ = ep["async_loop"](st["async_loop"], data,
                                                   eta, aligned=True)
        float(jnp.sum(st["async_loop"].x))
        out["async_loop"].append(time.perf_counter() - t0)
        # 1b. async one program
        t0 = time.perf_counter()
        st["async_one"], _ = one["async_one"](st["async_one"], data, eta,
                                              nepochs=E, aligned=True)
        float(jnp.sum(st["async_one"].x))
        out["async_one"].append(time.perf_counter() - t0)
        # 2a. sync per-epoch (blocking infos read each epoch)
        t0 = time.perf_counter()
        for _ in range(E):
            st["sync_loop"], infos = ep["sync_loop"](st["sync_loop"], data,
                                                     eta, aligned=True)
            np.asarray(infos)
        float(jnp.sum(st["sync_loop"].x))
        out["sync_loop"].append(time.perf_counter() - t0)
        # 2b. sync one program
        t0 = time.perf_counter()
        st["sync_one"], infos = one["sync_one"](st["sync_one"], data, eta,
                                                nepochs=E, aligned=True)
        np.asarray(infos)
        float(jnp.sum(st["sync_one"].x))
        out["sync_one"].append(time.perf_counter() - t0)
        # 3a. host reshuffle + re-upload + blocking read
        Xe, Ye = Xf, Yf
        t0 = time.perf_counter()
        for e in range(E):
            np.random.seed(1 + e)
            order = np.argsort(np.random.random(size=N))
            Xe, Ye = Xe[order], Ye[order]
            d = batchify((jnp.asarray(Xe), jnp.asarray(Ye)), BS)
            st["sched_loop"], infos = ep["sched_loop"](
                st["sched_loop"], d,
                jnp.float32(1e-2 / np.sqrt(e + 1)), aligned=True)
            np.asarray(infos)
        float(jnp.sum(st["sched_loop"].x))
        out["sched_loop"].append(time.perf_counter() - t0)
        # 3b. scheduled one program (schedule precompute on the clock)
        t0 = time.perf_counter()
        o_np, s_np = mk_schedule()
        st["sched_one"], infos = sched(st["sched_one"], (Xd, Yd),
                                       jnp.asarray(s_np, jnp.float32),
                                       jnp.asarray(o_np), batch_size=BS,
                                       aligned=True)
        np.asarray(infos)
        float(jnp.sum(st["sched_one"].x))
        out["sched_one"].append(time.perf_counter() - t0)

    med = {k: statistics.median(v) for k, v in out.items()}
    iters = E * NB
    print(f"{'regime':34s} {'ms/20ep':>9s} {'iters/s':>9s}")
    rows = [("async  per-epoch dispatch", "async_loop"),
            ("async  one program", "async_one"),
            ("sync   per-epoch dispatch", "sync_loop"),
            ("sync   one program", "sync_one"),
            ("shuffle host-loop (re-upload)", "sched_loop"),
            ("shuffle scheduled one program", "sched_one")]
    for label, k in rows:
        print(f"{label:34s} {med[k]*1e3:9.1f} {iters/med[k]:9.0f}")
    print(f"sync speedup  {med['sync_loop']/med['sync_one']:.2f}x ; "
          f"scheduled speedup {med['sched_loop']/med['sched_one']:.2f}x ; "
          f"async ratio {med['async_loop']/med['async_one']:.2f}x")


if __name__ == "__main__":
    main()
