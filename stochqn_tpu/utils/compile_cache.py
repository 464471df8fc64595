"""JAX's persistent compilation cache, at one fixed place.

The cache key includes the directory, so a directory that moves between
runs never hits.  :func:`enable` therefore uses ``JAX_COMPILATION_CACHE_DIR``
when it is set (and sets no other), and otherwise the fixed ``.jax_cache``
directory at the root of the checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable` uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on for every compilation, however short;
    returns its directory."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
