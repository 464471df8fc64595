"""Time XLA's two-loop step alone on the GPU, against the HBM roofline.

Usage: python benchmarks/two_loop_xla.py [N ...]    (default 292083 16000000)

For each width, pair storage (float32, bfloat16) and form (classic,
collapsed), ``two_loop_cached`` runs ``STEPS`` times inside one jitted
``fori_loop`` whose next gradient depends on the previous direction, so no
step can be skipped or overlapped with the next.  Reported per step:
microseconds, the bytes the step must move (two passes over the
``[2m, n]`` pair memory plus the ``[n]`` vectors), and the achieved share
of the device-memory bandwidth in ``bench.PEAKS``.  One JSON line per case;
the lines are also written to ``results/two_loop_xla.jsonl``.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp

from bench import peaks
from chip_smoke import MEM, synthetic_memory
from stochqn_tpu.ops.two_loop import two_loop_cached
from stochqn_tpu.utils.metrics import gpu_name_and_power_limit

STEPS = 200
REPS = 5


def step_bytes(n, itemsize):
    # projection + expansion read the [2m, n] buffer once each; the [n]
    # vectors: g read twice, g0 read, d written (float32)
    return 2 * (2 * MEM * n * itemsize) + 4 * n * 4


def time_case(mem, g0, collapsed):
    @jax.jit
    def chain(g0, mem):
        def body(_, g):
            d = two_loop_cached(g, mem, collapsed=collapsed)
            return g0 + 1e-3 * d
        return jax.lax.fori_loop(0, STEPS, body, g0)

    jax.block_until_ready(chain(g0, mem))          # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(g0, mem))
        times.append((time.perf_counter() - t0) / STEPS)
    return sorted(times)[REPS // 2]


def main(widths):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"two_loop_xla measures a GPU; JAX found "
                         f"{dev.platform!r}")
    _, peak_bw = peaks(dev.device_kind)
    smi = gpu_name_and_power_limit()
    print(f"device: {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    out_dir = os.path.join(REPO, "results")
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for n in widths:
        for storage in ("float32", "bfloat16"):
            mem = synthetic_memory(n, storage, seed=n)
            g0 = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
            itemsize = jnp.dtype(mem.s.dtype).itemsize
            for collapsed in (False, True):
                sec = time_case(mem, g0, collapsed)
                nbytes = step_bytes(n, itemsize)
                rec = {
                    "n": n,
                    "storage": str(jnp.dtype(mem.s.dtype)),
                    "form": "collapsed" if collapsed else "classic",
                    "us_per_step": sec * 1e6,
                    "bytes_per_step": nbytes,
                    "achieved_bytes_per_s": nbytes / sec,
                    "hbm_share": nbytes / sec / peak_bw,
                    "pair_memory_bytes": 2 * MEM * n * itemsize,
                    "device_kind": dev.device_kind,
                    "nvidia_smi_name_power_limit": smi,
                }
                print(json.dumps(rec), flush=True)
                lines.append(rec)
            del mem
    with open(os.path.join(out_dir, "two_loop_xla.jsonl"), "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(args or [292_083, 16_000_000])
