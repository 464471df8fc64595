"""Weak-scaling harness for data-parallel SQN.

Fixed per-device batch; devices 1..N.  By default the harness runs on a
virtual CPU mesh — it validates the scaling *mechanism* (sharded
batches, psum-reduced gradients, replicated state); with
``SCALING_ON_DEVICE=1`` it runs on the machine's GPUs, where each mesh
slot is a card.

    python benchmarks/scaling.py            # virtual CPU mesh (8 devices)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
if not os.environ.get("SCALING_ON_DEVICE") and "xla_cpu_max_isa" not in _flags:
    # Match tests/conftest.py: pin the CPU compile-target ISA so cache
    # entries written here stay loadable by every other CPU process
    # (the sandbox reports inconsistent CPUID across processes).
    _flags += " --xla_cpu_max_isa=AVX2"
os.environ["XLA_FLAGS"] = _flags.strip()

import jax
# Default to the virtual CPU mesh; set SCALING_ON_DEVICE=1 on real GPUs.
if not os.environ.get("SCALING_ON_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
from stochqn_tpu.utils import compile_cache
compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses
from stochqn_tpu.parallel import make_mesh, shard_batches, shard_state

N_FEATURES = 512
N_CLASSES = 32
PER_DEVICE_BATCH = 64
NUM_BATCHES = 32
EPOCHS = 3


def run(n_devices: int) -> float:
    rng = np.random.default_rng(0)
    bs = PER_DEVICE_BATCH * n_devices
    X = jnp.asarray(rng.standard_normal((NUM_BATCHES, bs, N_FEATURES)),
                    jnp.float32)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, bs))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES),
                     jnp.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-2)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=8), grad_fn)
    state = trainer.init(x0)

    mesh = make_mesh(n_data=n_devices, n_param=1,
                     devices=jax.devices()[:n_devices])
    state = shard_state(state, mesh)
    data = shard_batches((X, Y), mesh)

    epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))
    state, _ = epoch(state, data, jnp.float32(1e-2),      # warmup/compile
                     aligned=True)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(EPOCHS):
        state, _ = epoch(state, data, jnp.float32(1e-2), aligned=True)
    jax.block_until_ready(state)
    return EPOCHS * NUM_BATCHES / (time.perf_counter() - t0)


# -- param-sharded large-n weak scaling ------------------------------------ #
# Fixed per-device parameter count; the [2m, n] pair memory and all n-vectors
# are sharded over the param axis, so the two-loop's streaming passes scale
# with devices while its m-sized reductions ride one fused psum per step
# (tests/test_parallel.py locks the collective count).
# Small enough that the 8-virtual-device point (8x this n on ONE host, plus
# the [LN_BATCHES, n] centers and [2m, n] pair memory) stays in RAM — at
# 1M/device the 8-device point thrashed host memory and measured swap, not
# sharding overhead.  On a real slice, raise this to HBM scale.
N_PER_DEVICE = 250_000
LN_BATCHES = 16
LN_EPOCHS = 3


def run_param(n_devices: int) -> float:
    rng = np.random.default_rng(0)
    n = N_PER_DEVICE * n_devices
    diag = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal(n), jnp.float32)
    # centers [B, 1, n]: a least-squares-style stochastic quadratic whose
    # gradient is one elementwise pass — the two-loop dominates, which is
    # the regime param sharding exists for.
    centers = jnp.asarray(
        rng.standard_normal((LN_BATCHES, 1, n)).astype(np.float32))

    def grad_fn(x, batch):
        (c,) = batch
        return diag * (x - c[0])

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=4,
                                use_grad_diff=True), grad_fn)
    state = trainer.init(x0)

    mesh = make_mesh(n_data=1, n_param=n_devices,
                     devices=jax.devices()[:n_devices])
    state = shard_state(state, mesh)
    data = shard_batches((centers,), mesh)

    epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))
    state, _ = epoch(state, data, jnp.float32(1e-2), aligned=True)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(LN_EPOCHS):
        state, _ = epoch(state, data, jnp.float32(1e-2), aligned=True)
    jax.block_until_ready(state)
    return LN_EPOCHS * LN_BATCHES / (time.perf_counter() - t0)


def sweep(fn, label, virtual):
    """Weak scaling: per-device work is fixed, so global work per iteration
    grows with the device count.  On real multi-chip hardware compute grows
    with it and `iters_per_s(N)/iters_per_s(1)` is the efficiency.  On the
    virtual CPU mesh the N "devices" share one host's silicon, so ideal
    weak scaling is `iters_per_s ~ 1/N`; the sharding-machinery overhead is
    then `N * iters_per_s(N)/iters_per_s(1)` (compute-normalized).  Both are
    reported; read `weak_scaling_efficiency` on hardware and
    `compute_normalized_efficiency` on the virtual mesh."""
    ndev = len(jax.devices())
    results = {}
    base = None
    for d in [1, 2, 4, 8]:
        if d > ndev:
            break
        ips = fn(d)
        if base is None:
            base = ips
        eff = ips / base
        norm = eff * d if virtual else eff
        results[str(d)] = {
            "iters_per_s": round(ips, 2),
            "weak_scaling_efficiency": round(eff, 3),
            "compute_normalized_efficiency": round(norm, 3),
        }
        print(f"{label} {d} device(s): {ips:8.1f} iters/s  "
              f"(raw {eff:.2f}, compute-normalized {norm:.2f})")
    return results


def main():
    virtual = not os.environ.get("SCALING_ON_DEVICE")
    out = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "virtual_mesh": virtual,
        "note": ("virtual mesh: N devices share one host's compute, so ideal "
                 "weak scaling is iters_per_s ~ 1/N; "
                 "compute_normalized_efficiency = N * ips(N)/ips(1) isolates "
                 "the sharding/collective overhead and is the number that "
                 "predicts real-hardware efficiency") if virtual else
                "real hardware: weak_scaling_efficiency is the headline",
        "data_parallel_weak_scaling": sweep(run, "data-parallel", virtual),
        "param_sharded_weak_scaling_250k_per_dev":
            sweep(run_param, "param-sharded", virtual),
    }
    print(json.dumps(out))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "results"), exist_ok=True)
    path = os.path.join(here, "results", "scaling.json")
    # MERGE into the existing file: this script only owns the virtual-mesh
    # sections; the multiprocess scripts write their own.
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(out)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)


if __name__ == "__main__":
    main()
