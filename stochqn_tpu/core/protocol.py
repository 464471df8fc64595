"""Device-side request record returned by every ``advance`` call.

The reference's ``run_*`` functions return a task enum, an info enum and an
``iter_status`` int through out-pointers (``include/stochqn.h:381-383``).
Here they come back as a tiny pytree of int32 scalars alongside the new
state; the host-side free-mode wrapper turns them into the reference's
request dict (``stochqn/_optimizers.py:1004-1016``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from stochqn_tpu.core.enums import Info
from stochqn_tpu.core.pytree import dataclass


@dataclass
class AdvanceResult:
    task: jax.Array       # int32 Task code
    info: jax.Array       # int32 Info code
    x_changed: jax.Array  # bool: did x move during this call


def result(task, info, x_changed) -> AdvanceResult:
    return AdvanceResult(
        task=jnp.asarray(task, jnp.int32),
        info=jnp.asarray(info, jnp.int32),
        x_changed=jnp.asarray(x_changed, bool),
    )


def select(pred: jax.Array, if_true, if_false):
    """Elementwise pytree select (both sides computed; use for cheap paths)."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), if_true, if_false)


NO_PROBLEMS = jnp.int32(Info.NO_PROBLEMS_ENCOUNTERED)
