"""Benchmark: fused SQN on the BibTeX-shaped multinomial logistic workload.

Prints the device (platform, kind, count, and the card's name and power
limit from ``nvidia-smi``) and then ONE JSON line:
{"metric": ..., "value": N, "unit": ..., ...} with the median of repeated
timings, their spread, model FLOP/s and two roofline floors.  It refuses to
run anywhere but on a GPU listed in :data:`PEAKS`.

The workload mirrors the reference's README benchmark setup
(``example/example_stochqn.ipynb``: BibTeX 6,655 train x 1,836 features x
159 classes, batch_size=50, reg_param=1e-1) with synthetic data of the same
shape.  The metric is optimizer iterations per second END-TO-END — each
iteration includes its minibatch gradient evaluation, and every
``bfgs_upd_freq`` iterations the big-batch ``jvp`` Hessian-vector product
and correction-pair update, exactly like the reference's accounting.

``value`` is the MEDIAN of ``N_REPS`` timed repetitions; ``spread_pct`` is
(max-min)/median.  ``vs_baseline`` compares with the reference C core's
float32 build when ``benchmarks/reference_baseline.py`` has written
``BASELINE_MEASURED.json`` (gitignored) on the same host; otherwise null.

Cost model (closed form, per amortized iteration; b=50 rows, f=1836
features (+1 bias), c=159 classes, n=(f+1)*c params, m=10 pairs):
    gradient   = X@W fwd + X^T@dP bwd            = 2*(2*b*f*c) FLOPs
    two-loop   = projection + expansion over the [2m, n] pair memory
                                                  = 2*(2*(2m)*n) FLOPs
    updates    ~ 8*n elementwise (x, x_sum, rescale, step)
    boundary   (every L=20 iters, big batch B=L*b=1000 rows): jvp
               Hessian-vector product, 4 matmuls = 4*(2*B*f*c) / L FLOPs
Bytes per iteration (f32):
    pair memory read twice (projection + expansion) = 2*(2m*n*4)
    batch X read                                    = b*f*4
    ~8 n-vector reads/writes                        = 8*n*4
    boundary: big X twice + one pair-memory pass    / L
Two floors follow.  ``floor_us_hbm_streamed`` counts every byte above as
read from device memory.  ``floor_us_l2_resident`` counts only the batch,
the n-vectors and the boundary's big batch: it holds if the [2m, n] pair
memory (23.4 MB here) stays in the card's 50 MB L2 across steps, so the two
per-step passes over it never reach device memory.  Both divide by the
device-memory bandwidth of :data:`PEAKS`.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses
from stochqn_tpu.utils.metrics import gpu_name_and_power_limit

# BibTeX shapes (example/example_stochqn.ipynb cell-1 output)
N_FEATURES = 1836
N_CLASSES = 159
BATCH_SIZE = 50
NUM_BATCHES = 120          # 6000 of the 6655 train rows (aligned to upd_freq)
UPD_FREQ = 20
MEM_SIZE = 10
REG = 1e-1
STEP = 1e-2
DTYPE = jnp.float32

N_REPS = 7
EPOCHS_PER_REP = 20        # one device program of 2,400 iterations per rep

# Published peaks, keyed by ``device_kind``: (dense bf16 FLOP/s, device
# memory bytes/s).  NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense,
# 3.35 TB/s HBM3, both at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def peaks(device_kind: str):
    """``(bf16 FLOP/s, bytes/s)`` of a device; an unknown device is an
    error, not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "row to bench.PEAKS with a source") from None


def model_costs():
    """Closed-form ``(FLOPs, bytes if HBM-streamed, bytes if the pair
    memory is L2-resident)`` per amortized optimizer iteration."""
    b, f, c = BATCH_SIZE, N_FEATURES, N_CLASSES
    n = (f + 1) * c
    two_m = 2 * MEM_SIZE
    L = UPD_FREQ
    big = L * b

    grad_flops = 2 * (2 * b * f * c)
    twoloop_flops = 2 * (2 * two_m * n)
    update_flops = 8 * n
    boundary_flops = 4 * (2 * big * f * c) / L
    flops_per_iter = (grad_flops + twoloop_flops + update_flops
                      + boundary_flops)

    pair_bytes = 2 * (two_m * n * 4)
    batch_bytes = b * f * 4
    vec_bytes = 8 * n * 4
    big_batch_bytes = 2 * (big * f * 4) / L
    boundary_pair_bytes = 2 * (two_m * n * 4) / L
    bytes_hbm = (pair_bytes + batch_bytes + vec_bytes + big_batch_bytes
                 + boundary_pair_bytes)
    bytes_l2_resident = batch_bytes + vec_bytes + big_batch_bytes
    return flops_per_iter, bytes_hbm, bytes_l2_resident


def build():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal(
        (NUM_BATCHES, BATCH_SIZE, N_FEATURES)), DTYPE)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = jnp.asarray(np.eye(N_CLASSES)[labels], DTYPE)
    x0 = jnp.asarray(rng.standard_normal((N_FEATURES + 1) * N_CLASSES), DTYPE)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, REG)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ),
        grad_fn, donate=True)
    return trainer, trainer.init(x0), (X, Y)


def reference_baseline():
    """The reference C core's float32 rate measured on this host by
    ``benchmarks/reference_baseline.py``, or None."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ref = json.load(f)
    return (ref.get("reference_sqn_bibtex_iters_per_s_f32")
            or ref.get("reference_sqn_bibtex_iters_per_s"))


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform!r}")
    peak_flops, peak_bw = peaks(dev.device_kind)
    smi = gpu_name_and_power_limit()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {smi}", flush=True)

    trainer, state, data = build()
    epochs_fn = trainer.jit_epochs()   # state carry donated (in-place pairs)
    eta = jnp.asarray(STEP, DTYPE)

    # warmup / compile: the same static nepochs as the timed reps, so
    # nothing recompiles inside the timing loop
    t0 = time.perf_counter()
    state, _ = epochs_fn(state, data, eta, nepochs=EPOCHS_PER_REP,
                         aligned=True)
    jax.block_until_ready(state)
    compile_s = time.perf_counter() - t0

    # one extra leading rep, reported separately and excluded from the
    # median/spread
    reps = []
    for _ in range(N_REPS + 1):
        t0 = time.perf_counter()
        state, infos = epochs_fn(state, data, eta,
                                 nepochs=EPOCHS_PER_REP, aligned=True)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        reps.append(EPOCHS_PER_REP * NUM_BATCHES / dt)
    if not bool(jnp.all(jnp.isfinite(state.x))):
        raise RuntimeError("non-finite iterate — bench invalid")

    cold_rep, reps = reps[0], reps[1:]
    med = statistics.median(reps)
    spread_pct = 100.0 * (max(reps) - min(reps)) / med
    ref_ips = reference_baseline()

    flops_per_iter, bytes_hbm, bytes_l2 = model_costs()
    stats = dev.memory_stats() or {}
    print(json.dumps({
        "metric": "sqn_bibtex_iters_per_s",
        "value": med,
        "unit": "iters/s",
        "vs_baseline": None if ref_ips is None else med / ref_ips,
        "reps": reps,
        "cold_rep_iters_per_s": cold_rep,
        "spread_pct": spread_pct,
        "compile_and_first_rep_s": compile_s,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi_name_power_limit": smi,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "us_per_iter": 1e6 / med,
        "model_tflops_per_s": med * flops_per_iter / 1e12,
        "mfu_pct_bf16_peak": 100.0 * med * flops_per_iter / peak_flops,
        "floor_us_hbm_streamed": bytes_hbm / peak_bw * 1e6,
        "floor_us_l2_resident": bytes_l2 / peak_bw * 1e6,
        "bytes_per_iter_hbm_streamed": int(bytes_hbm),
        "bytes_per_iter_l2_resident": int(bytes_l2),
        "flops_per_iter": int(flops_per_iter),
        "note": ("floor_us_hbm_streamed counts the pair memory's two "
                 "per-step passes, the batch, the n-vectors and the "
                 "boundary's big batch and pair pass as device-memory "
                 "traffic; floor_us_l2_resident drops the pair-memory "
                 "bytes (the 23.4 MB [2m, n] buffer fits the 50 MB L2). "
                 "cold_rep is the first timed rep, excluded from the "
                 "median and spread"),
    }))


if __name__ == "__main__":
    main()
