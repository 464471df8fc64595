"""Multi-PROCESS parallelism over a localhost jax.distributed cluster.

The virtual 8-device mesh used everywhere else runs in one process; these
tests spawn two real worker processes (4 virtual CPU devices each) that
form one jax.distributed cluster over a localhost Gloo coordinator — the
same code path (initialize / global mesh / process-local ingestion /
cross-host collectives) a real multi-host GPU cluster uses, per SURVEY §2's
"distributed comm backend" row.

The matrix covers all three optimizers x both mesh layouts:

  * ``dp``    — pure data parallelism: gradients / Fisher terms / function
    values psum across processes, state replicated.
  * ``param`` — large-n layout: the example axis spans the processes while
    every ``[*, n]`` state array (x, pair memories, Fisher ring, RMSProp
    accumulator) is sharded over each process's local devices, so the
    two-loop projection, pair commits (oLBFGS: every iteration), and the
    adaQN Fisher gemvs all reduce through collectives.

Each cell asserts:
  * both workers finish and produce IDENTICAL final iterates (any
    cross-process divergence means broken collectives),
  * the distributed trajectory matches a single-process run of the same
    global problem (sharding is semantically invisible).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import dist_common as dc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cluster(tmp_path, optimizer, topology, nproc, local_devices):
    """Spawn ``nproc`` workers (``local_devices`` virtual CPU devices each),
    wait, and assert cross-process identity + single-process equivalence."""
    port = _free_port()
    outs = [tmp_path / f"w{i}.txt" for i in range(nproc)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # workers set their own
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DIST_TEST_LOCAL_DEVICES"] = str(local_devices)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nproc), str(port),
             str(outs[i]), optimizer, topology],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)
    ]
    logs = [p.communicate(timeout=360)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    xs = [np.array([float(v) for v in out.read_text().split()])
          for out in outs]
    # replicated/reassembled state: every process must hold the identical
    # global iterate
    for x in xs[1:]:
        np.testing.assert_array_equal(xs[0], x)
    # ...and the sharding must be semantically invisible
    ref = dc.run_single_process(optimizer)
    np.testing.assert_allclose(xs[0], ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("topology", dc.TOPOLOGIES)
@pytest.mark.parametrize("optimizer", dc.OPTIMIZERS)
def test_two_process_epoch(tmp_path, optimizer, topology):
    _run_cluster(tmp_path, optimizer, topology, nproc=2, local_devices=4)


@pytest.mark.parametrize("topology", dc.TOPOLOGIES)
def test_four_process_epoch(tmp_path, topology):
    """>2-process cell: collective group size 4 along the cross-process
    axis catches group-size-dependent bugs (reduction trees, ring order)
    that any pairwise exchange is insensitive to.  4 procs x 2 local
    devices = the same 8-device global mesh as the 2-process cells, so the
    single-process reference trajectory is unchanged."""
    _run_cluster(tmp_path, "SQN", topology, nproc=4, local_devices=2)
