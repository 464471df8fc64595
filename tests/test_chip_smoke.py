"""``chip_smoke.py``'s phases at small widths on the CPU.

The script itself refuses to run without a GPU; its phase functions are
plain code and are checked here against the same float64 oracle and the
same tolerances the card must meet.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# 61 batches of 50 rows: enough for the 60 oracle iterations
FEATURES, CLASSES, ROWS = 40, 7, 3050


@pytest.fixture(scope="module")
def problem():
    return cs.make_problem(0, FEATURES, CLASSES, ROWS)


@pytest.mark.parametrize("kind", ["SQN", "oLBFGS", "adaQN"])
def test_fused_phase_matches_oracle(problem, kind):
    X, Y, x0 = problem
    rel_x, rel_loss = cs.fused_vs_oracle(kind, X, Y, x0)
    assert rel_x <= cs.TOL_X and rel_loss <= cs.TOL_LOSS, (rel_x, rel_loss)
    trace = cs.fused_epochs(kind, X, Y, x0, epochs=2)
    assert all(b < a for a, b in zip(trace, trace[1:])), trace


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_two_loop_phase_matches_oracle(storage):
    errs = cs.two_loop_errors(3000, storage, seed=0)
    assert set(errs) == {"classic", "collapsed"}
    assert max(errs.values()) <= cs.TOL_TWO_LOOP[storage], errs


def test_protocol_phase_in_lockstep(problem):
    X, Y, x0 = problem
    assert cs.protocol_vs_oracle(X, Y, x0, requests=60) <= cs.TOL_X


def test_four_card_phase_on_virtual_devices():
    # conftest gives the CPU backend 8 virtual devices; the phase takes 4.
    # 4,000 rows: one round of L=20 batches of 200
    X, Y, x0 = cs.make_problem(1, FEATURES, CLASSES, 4000)
    cs.phase_four_cards(X, Y, x0, n_large=4096)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.gpu
def test_bibtex_width_on_gpu(gpu):
    """The fused SQN trajectory and the two-loop at the BibTeX width, on
    the card, against the float64 oracle."""
    X, Y, x0 = cs.make_problem(0, cs.FEATURES, cs.CLASSES, cs.ROWS)
    rel_x, rel_loss = cs.fused_vs_oracle("SQN", X, Y, x0)
    assert rel_x <= cs.TOL_X and rel_loss <= cs.TOL_LOSS, (rel_x, rel_loss)
    for storage in ("float32", "bfloat16"):
        errs = cs.two_loop_errors(292_083, storage, seed=0)
        assert max(errs.values()) <= cs.TOL_TWO_LOOP[storage], errs
