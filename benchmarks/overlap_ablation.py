"""Measure the EXPOSED collective cost directly (2-process cluster).

Whether XLA overlaps the gradient all-reduce with independent compute
decides how much of the collective's time is exposed.  This harness
measures the exposure between CPU processes:

  A ("cluster"):  2 real processes, jax.distributed cluster, global
      (2-data x 1-param) mesh — every step's gradient mean psums across
      the processes.
  B ("ablated"):  the SAME 2 processes with the SAME distributed runtime
      initialized, the same pinned cores, the same per-process compute —
      but each builds a LOCAL 1-device mesh over its own data, so the
      compiled program is collective-free.  (Unlike scaling_multiprocess
      .py's "independent" baseline, the cluster runtime stays up, so the
      ONLY difference between A and B is the collectives themselves.)

  exposed_collective_us = t_step(A) - t_step(B)     per pair, median
  weak_scaling_eff      = ips(A) / ips(B)

Pairs are interleaved in time (rep k of A and B adjacent).  The
recurrent compute-dominated model from scaling_multiprocess.py is swept
over DEPTH: per-step compute grows linearly with depth while the collective payload (d*d*4 = 1 MB) is
constant, so if the exposed cost is a fixed per-step toll, efficiency
must rise toward 1 with depth.

Known host artifacts:
TCP slow-start-after-idle (mitigated here via sysctl when permitted,
recorded either way) and an XLA-CPU collective-after-deep-AD anomaly
(the depth sweep quantifies whether it scales with depth).

Run: python benchmarks/overlap_ablation.py            (~15 min)
Writes results/scaling.json["overlap_ablation"] (merge, not overwrite).
"""
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

D = 512                 # recurrent width: psum payload d*d*4 = 1 MB
NB = 4                  # batches per epoch
L = 4                   # upd_freq (use_grad_diff boundary every L steps)
# Cells: (depth, rows/process).  depth x4 and bs x4 grow per-step compute
# by the same factor but only depth lengthens the backward chain — the
# pair discriminates whether the exposed cost tracks the AD DEPTH (then
# the wide cell escapes to >=0.9) or total compute (then no
# compute-dominated config on this host can, and that is the account).
CELLS = {
    "depth_36": (36, 512),
    "depth_144": (144, 512),
    "wide_bs2048": (36, 2048),
    # group-size-4 cell: same shape as the wide_bs2048 cell, but a
    # 4-process cluster.  This host has only 4
    # cores, so each worker gets ONE core (vs two in the 2-proc cells) —
    # absolute rates are not comparable across group sizes, but the
    # cluster/ablated pair inside the cell shares resources exactly, so
    # eff and exposed_collective_us remain well-defined.
    "wide_bs2048_4proc": (36, 2048),
}
REPS = {"depth_36": 7, "depth_144": 3, "wide_bs2048": 5,
        "wide_bs2048_4proc": 3}
EPOCHS_TIMED = {"depth_36": 3, "depth_144": 1, "wide_bs2048": 1,
                "wide_bs2048_4proc": 1}
PROCS = {"wide_bs2048_4proc": 4}          # default 2

SCALING_PATH = os.path.join(REPO, "results", "scaling.json")


def worker(pid, nproc, port, cell, mode):
    depth, bs = CELLS[cell]
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1"
                               " --xla_cpu_max_isa=AVX2")
    ncpu = os.cpu_count() or 4
    if nproc * 2 <= ncpu:
        os.sched_setaffinity(0, {2 * pid, 2 * pid + 1})
    else:                       # 4-proc cell on the 4-core host: 1 core each
        os.sched_setaffinity(0, {pid % ncpu})
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from stochqn_tpu.utils import compile_cache
    compile_cache.enable()
    # BOTH modes initialize the distributed runtime — the ablation must
    # only remove the collectives, not the cluster machinery
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from stochqn_tpu.core.config import SQNConfig
    from stochqn_tpu.fused import FusedTrainer
    from stochqn_tpu.parallel import distributed, make_mesh, shard_batches

    n = D * D
    k_out = int(np.sqrt(depth))
    assert k_out * k_out == depth
    rng = np.random.default_rng(100 + pid)
    local = rng.standard_normal((NB, bs, D)).astype(np.float32)

    def loss(x, batch):
        w = x.reshape(D, D) / jnp.sqrt(jnp.float32(D))

        def inner(h):
            def stp(h2, _):
                return jnp.tanh(h2 @ w), None
            return jax.lax.scan(stp, h, None, length=k_out)[0]

        def outer(h, _):
            return jax.checkpoint(inner)(h), None

        h = jax.lax.scan(outer, batch, None, length=k_out)[0]
        return jnp.mean(jnp.sum(h * h, axis=-1))

    grad_fn = jax.grad(loss)
    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=5, bfgs_upd_freq=L,
                                use_grad_diff=True),
        grad_fn, donate=True)

    if mode == "cluster":
        mesh = distributed.global_mesh()
        state = distributed.replicate_global(
            trainer.init(jnp.zeros(n, jnp.float32)), mesh)
        data = distributed.global_batches(local, mesh)
    else:  # ablated: local mesh, zero collectives, same runtime
        mesh = make_mesh(n_data=1, n_param=1,
                         devices=jax.local_devices()[:1])
        state = trainer.init(jnp.zeros(n, jnp.float32))
        data = shard_batches(jnp.asarray(local), mesh)

    epoch = trainer.jit_epoch()
    state, _ = epoch(state, data, jnp.float32(0.05), aligned=True)
    float(jnp.sum(state.x))  # warm + D2H barrier
    nep = EPOCHS_TIMED[cell]
    t0 = time.perf_counter()
    for _ in range(nep):
        state, _ = epoch(state, data, jnp.float32(0.05), aligned=True)
    float(jnp.sum(state.x))
    dt = time.perf_counter() - t0
    if pid == 0:
        print(json.dumps({"iters_per_s": nep * NB / dt,
                          "us_per_step": dt / (nep * NB) * 1e6}), flush=True)


def run_once(cell, mode):
    nproc = PROCS.get(cell, 2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         str(i), str(nproc), str(port), cell, mode],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(nproc)]
    out = [p.communicate(timeout=1800)[0] for p in procs]
    for p, log in zip(procs, out):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{log[-3000:]}")
    line = [ln for ln in out[0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def set_sysctl():
    """Disable TCP slow-start-after-idle (a measured localhost artifact:
    Gloo connections idle between steps re-enter slow start and the 1 MB
    all-reduce pays extra RTTs).  Recorded, not required."""
    key = "net.ipv4.tcp_slow_start_after_idle"
    try:
        prev = subprocess.run(["sysctl", "-n", key], capture_output=True,
                              text=True, timeout=10).stdout.strip()
        r = subprocess.run(["sysctl", "-w", f"{key}=0"],
                           capture_output=True, text=True, timeout=10)
        if r.returncode == 0:
            return f"set to 0 (was {prev})"
        return f"unavailable ({r.stderr.strip()[:80]})"
    except Exception as e:  # container without sysctl
        return f"unavailable ({e})"


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated cell names to (re)run; results "
                         "merge into the existing overlap_ablation section")
    args = ap.parse_args()
    cells = (list(CELLS) if args.only is None
             else [c.strip() for c in args.only.split(",")])
    for c in cells:
        if c not in CELLS:
            raise SystemExit(f"unknown cell {c!r}; have {list(CELLS)}")

    sysctl_state = set_sysctl()
    print(f"sysctl tcp_slow_start_after_idle: {sysctl_state}", flush=True)

    results = {
        "note": ("2-process cluster vs SAME-runtime collective-free "
                 "ablation (local mesh), interleaved pairs; recurrent "
                 f"model d={D}, psum payload 1 MB/step; cells sweep "
                 "backward DEPTH at fixed bs=512 and BATCH at fixed "
                 "depth=36 (equal-compute discriminator for what the "
                 "exposed cost scales with); "
                 "exposed_collective_us = t_step(cluster) - "
                 "t_step(ablated).  Depth sweep holds the payload "
                 "constant while compute grows."),
        "sysctl_tcp_slow_start_after_idle": sysctl_state,
    }
    for cell in cells:
        pairs = []
        for rep in range(REPS[cell]):
            a = run_once(cell, "cluster")
            b = run_once(cell, "ablated")
            exposed = a["us_per_step"] - b["us_per_step"]
            eff = a["iters_per_s"] / b["iters_per_s"]
            pairs.append({"cluster_us": round(a["us_per_step"], 1),
                          "ablated_us": round(b["us_per_step"], 1),
                          "exposed_collective_us": round(exposed, 1),
                          "eff": round(eff, 3)})
            print(f"{cell} pair {rep}: cluster "
                  f"{a['us_per_step'] / 1e3:8.1f} ms vs ablated "
                  f"{b['us_per_step'] / 1e3:8.1f} ms -> exposed "
                  f"{exposed / 1e3:7.1f} ms, eff {eff:.3f}", flush=True)
        effs = sorted(p["eff"] for p in pairs)
        exps = sorted(p["exposed_collective_us"] for p in pairs)
        results[cell] = {
            "n_processes": PROCS.get(cell, 2),
            "pairs": pairs,
            "exposed_collective_us_median": exps[len(exps) // 2],
            "weak_scaling_eff_median": effs[len(effs) // 2],
        }
        print(f"{cell}: median eff "
              f"{effs[len(effs) // 2]:.3f}, median exposed "
              f"{exps[len(exps) // 2] / 1e3:.1f} ms", flush=True)

    scaling = {}
    if os.path.exists(SCALING_PATH):
        with open(SCALING_PATH) as f:
            scaling = json.load(f)
    # merge per CELL: a partial (--only) run must never clobber the
    # other cells' recorded results
    section = scaling.get("overlap_ablation", {})
    section.update(results)
    scaling["overlap_ablation"] = section
    os.makedirs(os.path.dirname(SCALING_PATH), exist_ok=True)
    with open(SCALING_PATH, "w") as f:
        json.dump(scaling, f, indent=1)
    print("wrote results/scaling.json['overlap_ablation']")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               sys.argv[5], sys.argv[6])
    else:
        main()
