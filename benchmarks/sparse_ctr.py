"""Criteo-shaped sparse CTR benchmark (BASELINE config 5).

Synthetic ad-click workload: 1M hashed features, 39 active per example
(Criteo's 13 numeric + 26 categorical layout), binary labels, batch 512.
Features live in the padded-COO format (``models/sparse.py``) — the dense
matrix would be 512 x 1M per batch and can never exist on device.

Per step the gradient costs O(B*k) gather/scatter work while the two-loop
streams the [2m, n=1M] pair memory — the regime the reference covers with
CSR-aware sklearn internals (``stochqn/_logistic.py:36-247``) and that a
dense-only engine would OOM on.

Modes:
    python benchmarks/sparse_ctr.py            # one GPU
    python benchmarks/sparse_ctr.py --cpu-mesh # 8-virtual-device DP mesh,
                                               # streamed per-process-sliced
                                               # ingestion (mechanism check)

Writes one JSON line; appends nothing.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_MESH = "--cpu-mesh" in sys.argv

_flags = os.environ.get("XLA_FLAGS", "")
if CPU_MESH:
    if "xla_force_host_platform_device_count" not in _flags:
        _flags += " --xla_force_host_platform_device_count=8"
    if "xla_cpu_max_isa" not in _flags:
        _flags += " --xla_cpu_max_isa=AVX2"   # match tests/conftest.py
    os.environ["XLA_FLAGS"] = _flags.strip()

import jax

if CPU_MESH:
    jax.config.update("jax_platforms", "cpu")
from stochqn_tpu.utils import compile_cache
compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models.sparse import (sparse_binary_logistic_grad,
                                       sparse_binary_logistic_loss)

N_FEATURES = 1_000_000
K_ACTIVE = 40          # 39 padded to the bucket multiple
BATCH = 512
UPD_FREQ = 8
NUM_ROUNDS = 6         # batches per timed epoch = UPD_FREQ * NUM_ROUNDS
EPOCHS = 20     # long reps amortize the fixed per-rep host cost
REPS = 5
MEM = 10


def make_round(rng, n_rows):
    """One round of padded-COO batches: 13 'numeric' slots (fixed hash
    positions, standardized values) + 27 'categorical' slots (uniform
    hashes, value 1), like a hashed Criteo row."""
    num_idx = np.tile(np.arange(13, dtype=np.int32), (n_rows, 1))
    num_val = rng.standard_normal((n_rows, 13)).astype(np.float32)
    cat_idx = rng.integers(13, N_FEATURES, (n_rows, K_ACTIVE - 13),
                           dtype=np.int64).astype(np.int32)
    cat_val = np.ones((n_rows, K_ACTIVE - 13), np.float32)
    idx = np.concatenate([num_idx, cat_idx], axis=1)
    val = np.concatenate([num_val, cat_val], axis=1)
    y = rng.choice([-1.0, 1.0], size=n_rows,
                   p=[0.75, 0.25]).astype(np.float32)  # CTR-ish imbalance
    return idx, val, y


def main():
    rng = np.random.default_rng(0)
    nb = UPD_FREQ * NUM_ROUNDS

    def grad_fn(x, batch):
        bi, bv, by = batch
        return sparse_binary_logistic_grad(x, bi, bv, by, N_FEATURES,
                                           None, 1e-6)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=MEM, bfgs_upd_freq=UPD_FREQ,
                                use_grad_diff=True), grad_fn)

    if CPU_MESH:
        from stochqn_tpu.parallel import make_mesh, shard_batches, shard_state
        from stochqn_tpu.utils.data import prefetch_to_device, rounds_of
        from jax.sharding import NamedSharding, PartitionSpec as P

        ndev = len(jax.devices())
        mesh = make_mesh(n_data=ndev, n_param=1)
        state = shard_state(trainer.init(jnp.zeros(N_FEATURES)), mesh)
        batch_shard = NamedSharding(mesh, P(None, "data"))

        # Streamed, per-process-sliced ingestion: each "process" (here one,
        # but the slice helper is exercised) loads its rows, batches are
        # staged to device ahead of use, grouped into upd_freq rounds.
        from stochqn_tpu.parallel.distributed import process_local_batch_slice
        sl = process_local_batch_slice(BATCH)

        def batch_stream(n_batches):
            for _ in range(n_batches):
                idx, val, y = make_round(rng, BATCH)
                yield (jnp.asarray(idx[sl]), jnp.asarray(val[sl]),
                       jnp.asarray(y[sl]))

        round_fn = jax.jit(trainer.round)
        # warmup/compile
        stream = prefetch_to_device(rounds_of(batch_stream(UPD_FREQ),
                                              UPD_FREQ), sharding=batch_shard)
        for rd in stream:
            state, _ = round_fn(state, rd, jnp.float32(0.05))
        jax.block_until_ready(state)

        times = []
        for _ in range(REPS):
            stream = prefetch_to_device(rounds_of(batch_stream(nb), UPD_FREQ),
                                        sharding=batch_shard)
            t0 = time.perf_counter()
            for rd in stream:
                state, _ = round_fn(state, rd, jnp.float32(0.05))
            jax.block_until_ready(state)
            times.append(time.perf_counter() - t0)
        label = f"cpu-mesh-{ndev}dev-streamed"
    else:
        # One device: data pre-staged, chunked epochs (the hot path).
        idx, val, y = make_round(rng, nb * BATCH)
        data = (jnp.asarray(idx.reshape(nb, BATCH, K_ACTIVE)),
                jnp.asarray(val.reshape(nb, BATCH, K_ACTIVE)),
                jnp.asarray(y.reshape(nb, BATCH)))
        state = trainer.init(jnp.zeros(N_FEATURES))
        epoch_fn = jax.jit(trainer.epoch, static_argnames=("aligned",))
        state, _ = epoch_fn(state, data, jnp.float32(0.05), aligned=True)
        jax.block_until_ready(state)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(EPOCHS):
                state, _ = epoch_fn(state, data, jnp.float32(0.05),
                                    aligned=True)
            jax.block_until_ready(state)
            times.append((time.perf_counter() - t0) / EPOCHS)
        label = f"1dev-{jax.devices()[0].device_kind}"

    med = sorted(times)[len(times) // 2]
    ips = nb / med
    out = {
        "benchmark": "sparse_ctr",
        "mode": label,
        "n_features": N_FEATURES,
        "k_active": K_ACTIVE,
        "batch": BATCH,
        "mem_size": MEM,
        "upd_freq": UPD_FREQ,
        "iters_per_s_median": round(ips, 2),
        "reps_iters_per_s": [round(nb / t, 2) for t in times],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
