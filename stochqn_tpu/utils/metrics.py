"""Observability: iteration-info decoding, metrics accumulation, profiling.

The reference's observability surface was the per-call
``(x_changed_in_run, iteration_number, iteration_info)`` triple plus
verbose prints (``stochqn/_optimizers.py:1035-1044,372-377``).  The fused
engine returns the info codes for a whole epoch as one device array; these
helpers turn them into summaries, and :func:`trace` wraps ``jax.profiler``
for TensorBoard-compatible device traces.
"""
from __future__ import annotations

import contextlib
import subprocess
from collections import Counter
from typing import Dict

import numpy as np

from stochqn_tpu.core.enums import INFO_NAMES, Info


def summarize_infos(infos) -> Dict[str, int]:
    """Histogram an epoch's per-iteration info codes by name.

    ``infos`` is the ``[B]`` (or ``[epochs, B]``) int32 array returned by
    ``FusedTrainer.epoch`` / ``run_epochs``.
    """
    flat = np.asarray(infos).reshape(-1)
    counts = Counter(int(v) for v in flat)
    return {INFO_NAMES[Info(code)]: cnt for code, cnt in
            sorted(counts.items())}


def problem_iterations(infos) -> np.ndarray:
    """Indices of iterations that reported anything other than
    ``no_problems_encountered``."""
    flat = np.asarray(infos).reshape(-1)
    return np.nonzero(flat != int(Info.NO_PROBLEMS_ENCOUNTERED))[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a training region: ``with trace("/tmp/tb"): ...`` then view
    the device trace in TensorBoard / xprof."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for each card, to be
    printed beside every number measured on it (a card set below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class LossHistory:
    """Tiny helper for epoch-loss tracking with early-stop logic matching
    the guided driver (``stochqn/_optimizers.py:271-281``)."""

    def __init__(self, tol: float = 1e-1):
        self.tol = tol
        self.losses = []

    def update(self, loss: float) -> bool:
        """Record a loss; returns True when training should stop."""
        loss = float(loss)
        stop = False
        if self.losses:
            prev = self.losses[-1]
            stop = (prev - loss) < self.tol and loss <= prev
        self.losses.append(loss)
        return stop
