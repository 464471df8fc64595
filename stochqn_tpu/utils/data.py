"""Streaming ingestion: host -> device pipeline for fused training.

The reference streams data through ``partial_fit`` with a host-side
stored-batch container (``stochqn/_optimizers.py:288-337``).  The
on-device analogue: minibatches arrive from any host iterator, are
asynchronously staged to device memory ahead of use (double/triple buffering over the
dispatch queue), grouped into ``upd_freq``-sized rounds, and consumed by
the jitted :meth:`FusedTrainer.round` program — the round's batches are
exactly the big-batch correction set, mirroring the reference's "all
batches since the last correction" semantics.
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp


def parse_extreme_classification(path, n_features=None, n_labels=None):
    """Parse an Extreme Classification Repository dataset file.

    The format the reference's BibTeX example consumes
    (``/root/reference/example/example_stochqn.ipynb`` cell 1): a header
    line ``n_points n_features n_labels``, then one line per sample of
    ``lab1,lab2,... idx:val idx:val ...`` where the label list may be
    empty (line starts directly with ``idx:val`` pairs).

    Unlike the notebook's regex-plus-``eval`` parse, this is a plain
    tokenizer (no code execution on file contents).  Returns
    ``(X_csr [n, n_features], Y [n, n_labels] int8)`` with dimensions
    taken from the header (overridable via the keyword arguments).
    """
    import numpy as np
    from scipy.sparse import csr_matrix

    rows, cols, vals = [], [], []
    label_rows, label_cols = [], []
    with open(path, "rt") as f:
        i = 0

        def consume(parts):
            nonlocal i
            start = 0
            if ":" not in parts[0]:
                for lab in parts[0].split(","):
                    if lab:
                        label_rows.append(i)
                        label_cols.append(int(lab))
                start = 1
            for tok in parts[start:]:
                k, _, v = tok.partition(":")
                rows.append(i)
                cols.append(int(k))
                vals.append(float(v))
            i += 1

        # header = exactly three integer tokens; anything else on line 1
        # is data (a headerless file must not silently lose sample 0)
        first = f.readline().split()
        is_header = (len(first) == 3
                     and all(t.lstrip("-").isdigit() for t in first)
                     and ":" not in " ".join(first))
        if is_header:
            if n_features is None:
                n_features = int(first[1])
            if n_labels is None:
                n_labels = int(first[2])
        elif first:
            consume(first)
        for line in f:
            parts = line.split()
            if not parts:
                continue
            consume(parts)
    if n_features is None:
        n_features = max(cols) + 1 if cols else 0
    if n_labels is None:
        n_labels = max(label_cols) + 1 if label_cols else 0
    X = csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                   shape=(i, n_features))
    Y = np.zeros((i, n_labels), np.int8)
    Y[label_rows, label_cols] = 1
    return X, Y


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       sharding=None) -> Iterator:
    """Stage host batches onto the device ``size`` steps ahead.

    ``jax.device_put`` is asynchronous, so keeping a small queue of
    in-flight transfers overlaps H2D copies with computation — the
    data-loader half of the runtime the reference delegated to numpy
    slicing.
    """
    queue = collections.deque()

    def put(batch):
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sharding), batch)

    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out


def rounds_of(iterator: Iterable, upd_freq: int) -> Iterator:
    """Group a minibatch stream into stacked rounds of ``upd_freq``
    batches (leaves ``[upd_freq, bs, ...]``); drops a ragged tail."""
    it = iter(iterator)
    while True:
        chunk = list(itertools.islice(it, upd_freq))
        if len(chunk) < upd_freq:
            return
        yield jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs, axis=0), *chunk)


def stream_rounds(trainer, state, batch_iterator: Iterable, step_size,
                  prefetch: int = 2, sharding=None):
    """Consume a host minibatch stream with the fused engine.

    Args:
      trainer: a :class:`stochqn_tpu.fused.FusedTrainer`.
      state: its optimizer state (``niter`` must be a multiple of
        ``upd_freq``; true for a fresh state or between rounds).
      batch_iterator: yields minibatch pytrees (leaves ``[bs, ...]``).
      step_size: float or callable ``f(round_index) -> float``.

    Returns ``(state, infos)`` with ``infos`` concatenated over all
    consumed iterations.
    """
    upd_freq = getattr(trainer.cfg, "upd_freq", 1)
    round_fn = jax.jit(trainer.round)
    infos = []
    stream = prefetch_to_device(rounds_of(batch_iterator, upd_freq),
                                size=prefetch, sharding=sharding)
    for r, round_data in enumerate(stream):
        eta = step_size(r) if callable(step_size) else step_size
        state, info = round_fn(state, round_data, jnp.asarray(eta))
        infos.append(info)
    if not infos:
        raise ValueError(
            f"stream yielded fewer than upd_freq={upd_freq} batches")
    return state, jnp.concatenate(infos)
