"""Interleaved flat [2m, n] pair layout (``pairs_interleaved=True``) vs the
block [m, n]+[m, n] layout: identical accept decisions, same directions and
trajectories to float tolerance (the layouts contract the 2m memory rows in
a different order, so bitwise equality is not expected).

The layout exists for oLBFGS's every-iteration commits — one contiguous
[2, n] ring write instead of two [n] row writes (see
``core.state.BFGSMemoryInterleaved``; reference per-iteration commit:
``src/stochqn.c:1005-1007``).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stochqn_tpu.core.config import OLBFGSConfig, SQNConfig
from stochqn_tpu.core.state import BFGSMemory, BFGSMemoryInterleaved
from stochqn_tpu.core import olbfgs
from stochqn_tpu.fused import FusedTrainer, batchify
from stochqn_tpu.ops.pairs import commit_pair, conditional_flush
from stochqn_tpu.ops.two_loop import two_loop_cached

N, M = 37, 5


def _commit_stream(rng, k=12, n=N):
    """k (s, y, g) triples with mostly-positive curvature plus two rejects."""
    svecs = rng.standard_normal((k, n)).astype(np.float32)
    yvecs = (svecs * rng.uniform(0.5, 2.0, (k, 1))
             + 0.1 * rng.standard_normal((k, n))).astype(np.float32)
    if k > 7:
        yvecs[3] = -yvecs[3]
        yvecs[7] = -yvecs[7]
    gvecs = svecs[::-1].copy()
    return jnp.asarray(svecs), jnp.asarray(yvecs), jnp.asarray(gvecs)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _drive(svecs, yvecs, gvecs, interleaved, collapsed, storage_dtype=None,
           shift=True):
    if interleaved:
        mem = BFGSMemoryInterleaved.create(M, N, jnp.float32,
                                           storage_dtype, shift=shift)
    else:
        mem = BFGSMemory.create(M, N, jnp.float32, storage_dtype)

    def body(mem, sy):
        s, y, g = sy
        mem, acc = commit_pair(mem.replace(s_pending=s), y, 1e-4, 0.0,
                               direction_cache=collapsed)
        d = two_loop_cached(g, mem, collapsed=collapsed)
        return mem, (d, acc)

    mem, (ds, accs) = jax.lax.scan(body, mem, (svecs, yvecs, gvecs))
    return ds, accs, mem.count, mem.head


@pytest.mark.parametrize("collapsed", [False, True])
def test_directions_match_block_layout(rng, collapsed):
    """Commit/reject/wraparound stream: same accepts, same directions."""
    stream = _commit_stream(rng)
    d0, a0, c0, h0 = _drive(*stream, False, collapsed)
    d1, a1, c1, h1 = _drive(*stream, True, collapsed)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
    assert int(c0) == int(c1) == M                         # ring wrapped
    # block layout rotates head; the interleaved SHIFT layout pins it at 0
    assert int(h0) == 10 % M and int(h1) == 0
    assert int(np.sum(np.asarray(a0))) == 10               # rejects exercised
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("collapsed", [False, True])
def test_ring_mode_matches_block_layout(rng, collapsed):
    """The capacity-mode DUS ring (shift=False, taken automatically above
    state.SHIFT_MAX_BYTES) must also match the block layout — and rotate
    its head like a real ring."""
    stream = _commit_stream(rng)
    d0, a0, c0, h0 = _drive(*stream, False, collapsed)
    d1, a1, c1, h1 = _drive(*stream, True, collapsed, None, False)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
    assert int(c0) == int(c1) == M
    assert int(h0) == int(h1) == 10 % M       # both rotate
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1),
                               rtol=2e-5, atol=1e-6)


def test_bf16_storage_matches_block_layout(rng):
    stream = _commit_stream(rng)
    d0, a0, _, _ = _drive(*stream, False, False, jnp.bfloat16)
    d1, a1, _, _ = _drive(*stream, True, False, jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
    np.testing.assert_allclose(np.asarray(d0, np.float32),
                               np.asarray(d1, np.float32),
                               rtol=5e-2, atol=5e-3)


def test_flush_and_views(rng):
    stream = _commit_stream(rng, k=3)
    mem = BFGSMemoryInterleaved.create(M, N, jnp.float32)
    mem, _ = commit_pair(mem.replace(s_pending=stream[0][0]), stream[1][0],
                         1e-4, 0.0)
    # s/y properties are strided views of the interleaved [2m, n] buffer
    np.testing.assert_array_equal(np.asarray(mem.s), np.asarray(mem.sy[0::2]))
    np.testing.assert_array_equal(np.asarray(mem.y), np.asarray(mem.sy[1::2]))
    flushed = conditional_flush(mem, jnp.asarray(True))
    assert int(flushed.count) == 0 and int(flushed.head) == 0
    kept = conditional_flush(mem, jnp.asarray(False))
    assert int(kept.count) == 1


def _olbfgs_trainer(interleaved):
    cfg = OLBFGSConfig.create(mem_size=M, pairs_interleaved=interleaved)

    def grad_fn(x, batch):
        return x - jnp.mean(batch, axis=0)

    return FusedTrainer("oLBFGS", cfg, grad_fn)


@pytest.mark.parametrize("optimizer,cfg_kw", [
    ("oLBFGS", dict(mem_size=M)),
    ("SQN", dict(mem_size=M, bfgs_upd_freq=4, use_grad_diff=True)),
])
def test_fused_trajectory_matches_block_layout(rng, optimizer, cfg_kw):
    cfg_cls = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig}[optimizer]
    centers = jnp.asarray(rng.standard_normal((16, 8, N)), jnp.float32)

    def grad_fn(x, batch):
        return x - jnp.mean(batch, axis=0)

    xs = {}
    for interleaved in (False, True):
        cfg = cfg_cls.create(pairs_interleaved=interleaved, **cfg_kw)
        tr = FusedTrainer(optimizer, cfg, grad_fn)
        st = tr.init(jnp.zeros(N, jnp.float32))
        st, _ = tr.run_epochs(st, centers, 2, 0.05)
        xs[interleaved] = np.asarray(st.x)
    assert np.max(np.abs(xs[False])) > 0
    np.testing.assert_allclose(xs[True], xs[False], rtol=1e-4, atol=1e-7)


def test_knob_reaches_guided_and_free(rng):
    """pairs_interleaved threads through the public APIs down to the
    memory class (free-mode, guided oLBFGS/SQN)."""
    from stochqn_tpu.free import oLBFGS_free
    from stochqn_tpu.guided import SQN as GuidedSQN
    from stochqn_tpu.guided import oLBFGS as GuidedOLBFGS

    opt = oLBFGS_free(mem_size=3, pairs_interleaved=True)
    opt.run_optimizer(np.zeros(4), 1e-3)
    assert isinstance(opt.state.mem, BFGSMemoryInterleaved)

    g = GuidedOLBFGS(x0=np.zeros(4), grad_fun=lambda x, X, y, w: x,
                     pairs_interleaved=True, verbose=False)
    assert g.optimizer._cfg.pairs_interleaved
    s = GuidedSQN(x0=np.zeros(4), grad_fun=lambda x, X, y, w: x,
                  use_grad_diff=True, pairs_interleaved=True, verbose=False)
    assert s.optimizer._cfg.pairs_interleaved

    # native backend: JAX-engine options must be rejected, not ignored
    with pytest.raises(ValueError, match="backend"):
        oLBFGS_free(backend="native", pairs_interleaved=True)


def test_checkpoint_roundtrip(rng, tmp_path):
    from stochqn_tpu.utils.checkpoint import load_state, save_state
    tr = _olbfgs_trainer(True)
    st = tr.init(jnp.asarray(rng.standard_normal(N), jnp.float32))
    centers = jnp.asarray(rng.standard_normal((8, 8, N)), jnp.float32)
    st, _ = tr.run_epochs(st, centers, 1, 0.05)
    p = str(tmp_path / "st.npz")
    save_state(p, st)
    st2 = load_state(p, tr.init(jnp.zeros(N, jnp.float32)))
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_param_sharded_interleaved(rng):
    """sy shards its trailing (n) axis over the param mesh; trajectory
    matches the unsharded run."""
    from stochqn_tpu.parallel.mesh import PARAM_AXIS, make_mesh, shard_state
    n = 64
    cfg = OLBFGSConfig.create(mem_size=M, pairs_interleaved=True)

    def grad_fn(x, batch):
        return x - jnp.mean(batch, axis=0)

    tr = FusedTrainer("oLBFGS", cfg, grad_fn)
    centers = jnp.asarray(rng.standard_normal((8, 8, n)), jnp.float32)
    st = tr.init(jnp.zeros(n, jnp.float32))
    ref, _ = tr.run_epochs(st, centers, 1, 0.05)

    mesh = make_mesh(n_data=1, n_param=4, devices=jax.devices()[:4])
    st_sh = shard_state(tr.init(jnp.zeros(n, jnp.float32)), mesh)
    spec = st_sh.mem.sy.sharding.spec
    assert spec[-1] == PARAM_AXIS and spec[0] is None
    out, _ = tr.run_epochs(st_sh, centers, 1, 0.05)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                               rtol=1e-5, atol=1e-8)
