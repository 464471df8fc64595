"""Frozen dataclasses registered as JAX pytrees.

Optimizer states and request records are immutable dataclasses whose
array fields are pytree leaves, flattened in declaration order and keyed
by attribute name (``jax.tree_util.GetAttrKey``) — the keys
:mod:`stochqn_tpu.utils.checkpoint` writes into ``.npz`` files.  Fields
declared with :func:`static_field` are not leaves: they ride in the
treedef as auxiliary data, so a change of value retraces a jitted
function instead of becoming a traced array.
"""
from __future__ import annotations

import dataclasses

import jax

_STATIC = "static"


def static_field(default=dataclasses.MISSING):
    """A dataclass field kept in the treedef rather than as a leaf."""
    return dataclasses.field(default=default, metadata={_STATIC: True})


def dataclass(cls):
    """Make ``cls`` a frozen dataclass, register it as a pytree and give it
    a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get(_STATIC)],
        meta_fields=[f.name for f in fields if f.metadata.get(_STATIC)])
    cls.replace = dataclasses.replace
    return cls
