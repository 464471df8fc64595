"""Execute every Python example end-to-end (the reference's examples are
runnable documentation — ``example/c_rosen.c``, the notebook — and ours
must be too).

Each example runs as a SUBPROCESS with the CPU platform pinned and the
repository's persistent compile cache enabled by an exec-prelude, before
the example's own imports.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    sys.argv[1]))))
from stochqn_tpu.utils import compile_cache
compile_cache.enable()
path = sys.argv[1]
sys.argv = sys.argv[1:]
exec(compile(open(path).read(), path, "exec"),
     {"__name__": "__main__", "__file__": os.path.abspath(path)})
"""


def _run(name, *args, extra_env=None, timeout=420):
    env = dict(os.environ)
    env.update(extra_env or {})
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE,
         os.path.join(REPO, "examples", name), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, (
        f"{name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN"])
def test_rosenbrock_free_mode(optimizer):
    out = _run("rosenbrock_free_mode.py", "--optimizer", optimizer)
    fval = float(out.split("f = ")[1].split(",")[0])
    assert fval < 1e-8, out    # at the (1, 1) optimum


def test_checkpoint_resume():
    out = _run("checkpoint_resume.py")
    assert "OK" in out, out


def test_fused_tpu_training():
    out = _run("fused_training.py")
    # loss strictly decreasing across the printed epochs
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if "epoch" in line]
    assert len(losses) >= 3 and all(b < a for a, b in zip(losses, losses[1:])), out


def test_pytree_mlp_adaqn():
    out = _run("pytree_mlp_adaqn.py")
    assert "done" in out, out
    accs = [float(line.rsplit("acc", 1)[1])
            for line in out.splitlines() if "acc" in line]
    assert accs and accs[-1] >= 0.9, out


def test_data_parallel_sqn():
    out = _run("data_parallel_sqn.py",
               extra_env={"XLA_FLAGS":
                          "--xla_force_host_platform_device_count=8"})
    losses = [float(line.split("loss/row")[1].split()[0])
              for line in out.splitlines() if "loss/row" in line]
    assert len(losses) >= 2 and losses[-1] < losses[0], out


def test_sharded_guided_fit_example():
    out = _run("sharded_guided_fit.py",
               extra_env={"XLA_FLAGS":
                          "--xla_force_host_platform_device_count=8 "
                          "--xla_cpu_max_isa=AVX2"})
    assert "ONE device program" in out
    assert out.strip().endswith("ok")
