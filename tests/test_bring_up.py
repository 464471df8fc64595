"""What the package needs to start on a machine with only JAX, NumPy and
SciPy: the local pytree dataclass (in place of flax), the NumPy validation
split (in place of scikit-learn), the compile-cache rule, and the bench's
device table."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stochqn_tpu.core.config import AdaQNConfig
from stochqn_tpu.core.pytree import dataclass, static_field
from stochqn_tpu.core.state import (BFGSMemoryInterleaved, FisherMemory,
                                    SQNState)
from stochqn_tpu.guided import _valset_split
from stochqn_tpu.utils import checkpoint, compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pytree_dataclass_replace_and_static_field():
    @dataclass
    class Rec:
        a: jax.Array
        b: jax.Array
        mode: bool = static_field(default=False)

    r = Rec(a=jnp.zeros(2), b=jnp.ones(3), mode=True)
    r2 = r.replace(b=jnp.zeros(3))
    assert r2.mode is True and float(r2.b.sum()) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.a = jnp.ones(2)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2                  # the static field is no leaf
    assert jax.tree_util.tree_unflatten(treedef, leaves).mode is True
    # the static value is part of the treedef: jit retraces on a change
    assert treedef != jax.tree_util.tree_structure(r.replace(mode=False))

    for mem in (BFGSMemoryInterleaved.create(3, 8, shift=False),
                FisherMemory.create(4, 8, shift=True)):
        _, td = jax.tree_util.tree_flatten(mem)
        back = jax.tree_util.tree_unflatten(td, jax.tree_util.tree_leaves(
            mem))
        assert back.shift == mem.shift


def test_state_leaf_paths_and_checkpoint_keys(tmp_path):
    """Leaves keep their attribute names as path keys, so ``.npz``
    checkpoints written before the move off flax still load."""
    st = SQNState.create(jnp.arange(6.0), 3)
    keys = sorted(checkpoint._flatten_with_paths(st))
    assert keys == sorted(
        ["x", "grad_prev", "x_sum", "x_avg_prev", "niter", "section"]
        + [f"mem/{f}" for f in ("s", "y", "gram", "s_pending", "head",
                                "count", "perm", "rho", "bwd_inv",
                                "fwd_inv", "yy_c", "rl_c", "gamma", "c0",
                                "cg")])
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(st)[0]]
    assert all(isinstance(k, jax.tree_util.GetAttrKey)
               for p in paths for k in p)
    path = str(tmp_path / "st.npz")
    checkpoint.save_state(path, st)
    back = checkpoint.load_state(path, SQNState.create(jnp.zeros(6), 3))
    np.testing.assert_array_equal(back.x, st.x)


@pytest.mark.parametrize("n,frac,seed", [(40, 0.25, 13), (101, 0.1, 0),
                                         (7, 0.5, 3)])
def test_valset_split_matches_sklearn(n, frac, seed):
    from sklearn.model_selection import train_test_split
    rows = np.arange(n)
    train_ref, val_ref = train_test_split(rows, test_size=frac,
                                          random_state=seed)
    train, val = _valset_split(n, frac, seed)
    np.testing.assert_array_equal(train, train_ref)
    np.testing.assert_array_equal(val, val_ref)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_bench_peaks_reject_unknown_device():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.pop(0)
    assert bench.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks("cpu")


def test_adaqn_config_rejects_use_pallas():
    with pytest.raises(TypeError):
        AdaQNConfig.create(use_pallas=True)
    assert not hasattr(AdaQNConfig(), "use_pallas")
