"""Checkpoint / resume for optimizer states.

The reference had no serialization API, but its design was
checkpoint-friendly (all state in language-side holders,
``stochqn/_optimizers.py:791-879``; documented mutable fields,
``include/stochqn.h:163-167``).  Here the whole optimizer state is a pytree
— including the ``section`` coroutine resume point — so a snapshot restores
mid-protocol exactly.

:func:`save_state` / :func:`load_state` write and read a dependency-free
``.npz`` (leaves keyed by tree path), portable and human-inspectable.
"""
from __future__ import annotations

import numpy as np
import jax


def _path_key(path):
    return "/".join(str(getattr(p, "name", getattr(p, "idx", p)))
                    for p in path)


def _flatten_with_paths(state):
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(state)[0]
    return {_path_key(path): np.asarray(leaf)
            for path, leaf in leaves_with_paths}


def save_state(path: str, state) -> None:
    """Write an optimizer state pytree to a ``.npz`` file."""
    np.savez(path, **_flatten_with_paths(state))


def load_state(path: str, template):
    """Load a state saved by :func:`save_state` into the structure (and
    shardings, via the template's leaves) of ``template``."""
    with np.load(path) as data:
        flat = dict(data)

    # Template leaves are consulted for metadata (paths, shapes, dtypes,
    # shardings) only — never materialized to host, so multi-GB or
    # multi-host sharded templates work.
    leaves_with_paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    keys = {_path_key(path) for path, _ in leaves_with_paths}
    if keys != set(flat):
        missing = keys ^ set(flat)
        raise ValueError(f"checkpoint structure mismatch: {sorted(missing)}")

    new_leaves = []
    for path, leaf in leaves_with_paths:
        key = _path_key(path)
        arr = flat[key]
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        dtype = getattr(leaf, "dtype", np.asarray(leaf).dtype)
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape}, "
                f"template has {shape}")
        new_leaves.append(
            jax.device_put(arr.astype(dtype),
                           getattr(leaf, "sharding", None)))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)

