"""Multi-device tests on a virtual 8-device CPU mesh: data-parallel
reductions, parameter-axis sharding of the two-loop, and the fused trainer
under GSPMD sharding."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stochqn_tpu.core.config import SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.ops.two_loop import two_loop
from stochqn_tpu.parallel import (data_parallel_grad, data_parallel_hvp,
                                  data_parallel_value, make_mesh,
                                  param_sharding, shard_batches, shard_state)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return jnp.asarray(q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T)


def test_data_parallel_grad_matches_local(rng):
    n, bs = 12, 16
    a = _quad(rng, n)
    mesh = make_mesh(n_data=8, n_param=1)

    def grad_fn(x, batch):  # sum-over-examples gradient
        return jnp.sum(batch, axis=0) + 0.0 * x  # trivially separable

    dp = data_parallel_grad(grad_fn, mesh, reduction="sum")
    x = jnp.asarray(rng.standard_normal(n))
    batch = jnp.asarray(rng.standard_normal((bs, n)))
    np.testing.assert_allclose(np.asarray(dp(x, batch)),
                               np.asarray(grad_fn(x, batch)), rtol=1e-12)


def test_data_parallel_quadratic_grad(rng):
    n, bs = 10, 24
    a = _quad(rng, n)
    mesh = make_mesh(n_data=8, n_param=1)

    def grad_fn(x, batch):
        # sum over examples of A(x - c_i)
        return (a @ (x[:, None] - batch.T)).sum(axis=1)

    dp = data_parallel_grad(grad_fn, mesh, reduction="sum")
    x = jnp.asarray(rng.standard_normal(n))
    batch = jnp.asarray(rng.standard_normal((bs, n)))
    np.testing.assert_allclose(np.asarray(dp(x, batch)),
                               np.asarray(grad_fn(x, batch)), rtol=1e-10)


def test_data_parallel_value_and_hvp(rng):
    n, bs = 10, 16
    a = _quad(rng, n)
    mesh = make_mesh(n_data=8, n_param=1)

    def obj_fn(x, batch):
        r = x[None, :] - batch
        return 0.5 * jnp.einsum("bi,ij,bj->", r, a, r)

    def grad_fn(x, batch):
        return (a @ (x[:, None] - batch.T)).sum(axis=1)

    x = jnp.asarray(rng.standard_normal(n))
    v = jnp.asarray(rng.standard_normal(n))
    batch = jnp.asarray(rng.standard_normal((bs, n)))

    dv = data_parallel_value(obj_fn, mesh)
    np.testing.assert_allclose(float(dv(x, batch)), float(obj_fn(x, batch)),
                               rtol=1e-10)

    dh = data_parallel_hvp(grad_fn, mesh)
    want = jax.jvp(lambda xx: grad_fn(xx, batch), (x,), (v,))[1]
    np.testing.assert_allclose(np.asarray(dh(x, v, batch)),
                               np.asarray(want), rtol=1e-10)


def test_two_loop_param_sharded_matches(rng):
    """Sharding the parameter axis across 8 devices must not change the
    two-loop result (GSPMD inserts the psums)."""
    n, m = 64, 5
    mesh = make_mesh(n_data=1, n_param=8)
    s_mem = rng.standard_normal((m, n))
    y_mem = s_mem + 0.3 * rng.standard_normal((m, n))
    g = rng.standard_normal(n)

    ref = np.asarray(two_loop(jnp.asarray(g), jnp.asarray(s_mem),
                              jnp.asarray(y_mem), 0, m))

    g_s = jax.device_put(jnp.asarray(g), param_sharding(mesh, 1))
    s_s = jax.device_put(jnp.asarray(s_mem), param_sharding(mesh, 2))
    y_s = jax.device_put(jnp.asarray(y_mem), param_sharding(mesh, 2))
    out = jax.jit(lambda g, s, y: two_loop(g, s, y, 0, m))(g_s, s_s, y_s)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10)


def test_fused_trainer_sharded_epoch_matches_unsharded(rng):
    n, B, bs, L = 16, 8, 8, 4
    a = _quad(rng, n)

    def grad_fn(x, batch):
        return a @ (x - jnp.mean(batch, axis=0))

    cfg = SQNConfig.create(mem_size=3, bfgs_upd_freq=L)
    trainer = FusedTrainer("SQN", cfg, grad_fn)
    data = jnp.asarray(rng.standard_normal((B, bs, n)))
    state0 = trainer.init(jnp.zeros(n))

    st_plain, _ = jax.jit(trainer.epoch)(state0, data, 0.05)

    mesh = make_mesh(n_data=4, n_param=2)
    state_sh = shard_state(trainer.init(jnp.zeros(n)), mesh)
    data_sh = shard_batches(data, mesh)
    st_sh, _ = jax.jit(trainer.epoch)(state_sh, data_sh, 0.05)

    np.testing.assert_allclose(np.asarray(st_sh.x), np.asarray(st_plain.x),
                               rtol=1e-8, atol=1e-10)
    assert int(st_sh.niter) == B


def test_param_sharded_two_loop_single_psum(rng):
    """The compact two-loop's claim: under a sharded parameter axis the
    projection needs ONE fused all-reduce (plus one for the guard norm),
    not 4m sequential ones like the naive recursion."""
    n, m = 512, 6
    mesh = make_mesh(n_data=1, n_param=8)
    s_mem = jnp.asarray(rng.standard_normal((m, n)))
    y_mem = s_mem + 0.3 * jnp.asarray(rng.standard_normal((m, n)))
    g = jnp.asarray(rng.standard_normal(n))

    g_s = jax.device_put(g, param_sharding(mesh, 1))
    s_s = jax.device_put(s_mem, param_sharding(mesh, 2))
    y_s = jax.device_put(y_mem, param_sharding(mesh, 2))

    fn = jax.jit(lambda g, s, y: two_loop(g, s, y, 0, m))
    compiled = fn.lower(g_s, s_s, y_s).compile()
    hlo = compiled.as_text()
    n_allreduce = hlo.count("all-reduce-start") or hlo.count("all-reduce(")
    # projection (Wg + Gram fused) should reduce in O(1) collectives
    assert n_allreduce <= 3, f"{n_allreduce} all-reduces in param-sharded two_loop"


def test_param_sharded_adaqn_coupling_psum_counts(rng):
    """The diag-H0 coupling trade-off (AdaQNConfig.coupling): the gram
    form's n-contractions are independent, so they fuse into no more
    all-reduces than the matvec form, whose projection -> alpha ->
    coupling chain is sequential."""
    from stochqn_tpu.core.state import BFGSMemory
    from stochqn_tpu.ops.pairs import commit_pair
    from stochqn_tpu.ops.two_loop import two_loop_cached

    n, m = 512, 4
    mesh = make_mesh(n_data=1, n_param=8)
    mem = BFGSMemory.create(m, n, jnp.float32)
    for _ in range(m):
        s = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        y = s + 0.3 * jnp.asarray(rng.standard_normal(n).astype(np.float32))
        mem = mem.replace(s_pending=s)
        mem, _ = commit_pair(mem, y, 1e-8, 0.0)
    g = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    diag = jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32))

    mem_sh = shard_state(mem, mesh)
    g_sh = jax.device_put(g, param_sharding(mesh, 1))
    d_sh = jax.device_put(diag, param_sharding(mesh, 1))

    counts = {}
    for coupling in ("matvec", "gram"):
        fn = jax.jit(lambda g, mm_, d: two_loop_cached(
            g, mm_, diag=d, coupling=coupling))
        hlo = fn.lower(g_sh, mem_sh, d_sh).compile().as_text()
        counts[coupling] = (hlo.count("all-reduce-start")
                            or hlo.count("all-reduce("))
    # both stay O(1); gram must not need more collectives than matvec
    assert counts["gram"] <= counts["matvec"] <= 4, counts


# ===========================================================================
# Per-step collective BYTE budgets (what an interconnect roofline needs)
# ===========================================================================
# Each test compiles a loop-free per-step (or per-boundary) program under
# one of the dryrun topologies and asserts the total collective payload —
# parsed from the compiled HLO by parallel.hlo_stats — against a closed-form
# budget.  HLO shapes are per-device shards, so the bytes measured here are
# exactly what rides the interconnect per device.
from stochqn_tpu.parallel import collective_bytes, collective_ops  # noqa: E402


def _quad_trainer(rng, n, optimizer="SQN", m=3, L=4, **cfg_kw):
    from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig
    a_diag = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch, axis=0))

    def obj_fn(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * jnp.vdot(r, a_diag * r)

    if optimizer == "SQN":
        cfg = SQNConfig.create(mem_size=m, bfgs_upd_freq=L, **cfg_kw)
    elif optimizer == "adaQN":
        cfg = AdaQNConfig.create(mem_size=m, bfgs_upd_freq=L, **cfg_kw)
    else:
        cfg = OLBFGSConfig.create(mem_size=m, **cfg_kw)
    return FusedTrainer(optimizer, cfg, grad_fn, obj_fn=obj_fn)


def _warm_state(trainer, mesh, n, bs, rng):
    """A committed-pairs state placed on the mesh (so the two-loop's
    direction path, not the empty-memory fallback, is what compiles)."""
    data = jnp.asarray(
        rng.standard_normal((4, bs, n)).astype(np.float32))
    state = trainer.init(jnp.zeros(n, jnp.float32))
    state, _ = trainer.epoch(state, data, 0.05)
    return shard_state(state, mesh)


def test_collective_bytes_data_parallel_step(rng):
    """Pure DP (8 data x 1 param): the ONLY per-step collective is the
    gradient all-reduce — exactly n*4 payload bytes, group size 8."""
    import functools
    from stochqn_tpu.fused import _sqn_base

    n, bs = 512, 16
    mesh = make_mesh(n_data=8, n_param=1)
    trainer = _quad_trainer(rng, n)
    state = _warm_state(trainer, mesh, n, bs, rng)
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))

    fn = jax.jit(functools.partial(_sqn_base, trainer.cfg, trainer.grad_fn))
    hlo = fn.lower(state, batch, jnp.float32(0.05)).compile().as_text()
    ops = collective_ops(hlo)
    total = sum(op.payload_bytes for op in ops)
    assert n * 4 <= total <= n * 4 + 256, (total, [
        (o.kind, o.payload_bytes) for o in ops])
    assert all(op.group_size in (0, 8) for op in ops), ops


def test_collective_bytes_param_only_adaqn_step(rng):
    """Param-only (1 x 8): the per-step collectives are the two-loop's
    small-quantity psums — O(m) bytes, INDEPENDENT of n.  The [n]-sized
    tensors (x, grad, direction, Fisher rows) never cross the mesh."""
    import functools
    from stochqn_tpu.fused import _adaqn_base

    n, bs, m = 4096, 8, 3
    mesh = make_mesh(n_data=1, n_param=8)
    trainer = _quad_trainer(rng, n, optimizer="adaQN", m=m,
                            fisher_size=4, max_incr=1.01,
                            rmsprop_weight=0.9)
    state = _warm_state(trainer, mesh, n, bs, rng)
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "param")))

    fn = jax.jit(functools.partial(_adaqn_base, trainer.cfg,
                                   trainer.grad_fn))
    hlo = fn.lower(state, batch, jnp.float32(0.05)).compile().as_text()
    ops = collective_ops(hlo)
    total = sum(op.payload_bytes for op in ops)
    # wg [2m] + coupling y_r0 [m] + guard/curvature scalars, NOT O(n):
    assert 0 < total <= 1024, (total, [(o.kind, o.payload_bytes)
                                       for o in ops])
    assert total < n, "param-sharded step moved O(n) bytes"


def test_collective_bytes_mixed_mesh_sqn_round(rng):
    """(4 data x 2 param): per-step = one all-reduce of the gradient
    SHARD (n/2 * 4 bytes) + O(m^2) small psums; the every-L boundary adds
    the jvp's two gradient-shard reductions + the commit's curvature /
    Gram-insert psums.  Budgets hold per phase."""
    import functools
    from stochqn_tpu.fused import _sqn_base, _sqn_boundary

    n, bs, m, L, p = 512, 16, 3, 4, 2
    mesh = make_mesh(n_data=4, n_param=p)
    trainer = _quad_trainer(rng, n, m=m, L=L)
    state = _warm_state(trainer, mesh, n, bs, rng)
    spec = jax.sharding.PartitionSpec("data", "param")
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, spec))

    shard_bytes = n * 4 // p
    fn = jax.jit(functools.partial(_sqn_base, trainer.cfg, trainer.grad_fn))
    hlo = fn.lower(state, batch, jnp.float32(0.05)).compile().as_text()
    step_total = collective_bytes(hlo)
    assert shard_bytes <= step_total <= shard_bytes + 1024, step_total

    big = jax.device_put(
        jnp.asarray(rng.standard_normal((L * bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, spec))
    bfn = jax.jit(functools.partial(_sqn_boundary, trainer.cfg,
                                    trainer.grad_fn))
    bhlo = bfn.lower(state, big, jnp.zeros((), bool)).compile().as_text()
    btotal = collective_bytes(bhlo)
    # jvp primal+tangent gradient shards + commit smalls
    assert btotal <= 2 * shard_bytes + 4096, btotal


def test_collective_bytes_olbfgs_step_mixed_mesh(rng):
    """oLBFGS on (4 data x 2 param): every iteration runs TWO gradient
    all-reduces (calc_grad + same-batch grad) plus the per-iteration
    commit's curvature and incremental-Gram psums — still bounded by
    2 gradient shards + O(m) small payloads."""
    import functools
    from stochqn_tpu.fused import olbfgs_step

    n, bs, m, p = 512, 16, 3, 2
    mesh = make_mesh(n_data=4, n_param=p)
    trainer = _quad_trainer(rng, n, optimizer="oLBFGS", m=m,
                            min_curvature=1e-8)
    state = _warm_state(trainer, mesh, n, bs, rng)
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec("data", "param")))

    fn = jax.jit(functools.partial(olbfgs_step, trainer.cfg,
                                   trainer.grad_fn))
    hlo = fn.lower(state, batch, jnp.float32(0.05)).compile().as_text()
    total = collective_bytes(hlo)
    shard_bytes = n * 4 // p
    assert 2 * shard_bytes <= total <= 2 * shard_bytes + 4096, total


def test_hlo_stats_parses_tpu_async_and_tiled_forms():
    """Accelerator compiles emit async `-start` ops whose result tuple is
    (operand, result[, scratch]) — summing would double-count — and
    tiled layouts with parentheses inside the shape (`{0:T(512)}`) that
    must not truncate the tuple parse."""
    from stochqn_tpu.parallel.hlo_stats import collective_ops

    hlo = "\n".join([
        # sync, plain (CPU-style)
        "  %all-reduce = f32[64]{0} all-reduce(%wrapped), "
        "channel_id=1, replica_groups=[1,8]<=[8]",
        # async start with tiled layouts: payload = LARGEST element
        "  %ag = (f32[512]{0:T(512)}, f32[4096]{0:T(512)}) "
        "all-gather-start(f32[512]{0:T(512)} %p), "
        "replica_groups=[1,8]<=[8], dimensions={0}",
        # async all-reduce start: operand == result, max not sum
        "  %ar = (f32[256]{0:T(256)}, f32[256]{0:T(256)}) "
        "all-reduce-start(f32[256]{0:T(256)} %q), replica_groups=[2,4]<=[8]",
        # the matching -done carries no new payload
        "  %ard = f32[256]{0:T(256)} all-reduce-done(%ar)",
        # sync tuple = fused multi-tensor collective: elements SUM
        "  %fused = (f32[16]{0}, f32[8]{0}) all-reduce(%a, %b), "
        "replica_groups=[1,8]<=[8]",
    ])
    ops = collective_ops(hlo)
    got = [(o.kind, o.payload_bytes, o.group_size) for o in ops]
    assert ("all-reduce", 64 * 4, 8) in got
    assert ("all-gather", 4096 * 4, 8) in got           # max, not sum
    assert ("all-reduce", 256 * 4, 4) in got            # start: max
    assert ("all-reduce", 16 * 4 + 8 * 4, 8) in got     # sync tuple: sum
    # exactly these four (the -done matched as its own all-reduce? no:
    # "-done(" does not match the "(?:-start)?\(" pattern)
    assert len(ops) == 4, got


def test_hlo_stats_explicit_group_lists_and_permute():
    """XLA emits replica_groups in two encodings: the iota form (above)
    and the explicit-list form `{{0,1},{2,3}}`; the parser must derive
    the group size from the first group instead of silently reporting 0
    (advisor r3).  collective-permute (source_target_pairs, no groups)
    and empty `replica_groups={}` stay group_size=0=unknown; any OTHER
    payload-carrying collective with unparsed groups raises."""
    import pytest
    from stochqn_tpu.parallel.hlo_stats import collective_ops

    hlo = "\n".join([
        "  %ar = f32[64]{0} all-reduce(%p), channel_id=1, "
        "replica_groups={{0,1},{2,3}}, to_apply=%add",
        "  %cp = f32[32]{0} collective-permute(%q), "
        "source_target_pairs={{0,1},{1,0}}",
        "  %ar2 = f32[16]{0} all-reduce(%r), replica_groups={}, "
        "to_apply=%add",
    ])
    ops = collective_ops(hlo)
    got = [(o.kind, o.payload_bytes, o.group_size) for o in ops]
    assert ("all-reduce", 64 * 4, 2) in got
    assert ("collective-permute", 32 * 4, 0) in got
    assert ("all-reduce", 16 * 4, 0) in got
    assert len(ops) == 3, got

    with pytest.raises(ValueError, match="unparsed replica_groups"):
        collective_ops("  %bad = f32[64]{0} all-reduce(%p), to_apply=%add")


# ===========================================================================
# Round-4 flagship paths under meshes: scheduled whole-fit dispatch, bf16
# pair/Fisher storage, sparse padded-COO gradients
# ===========================================================================
def test_scheduled_whole_fit_sharded_matches_unsharded(rng):
    """jit_epochs_scheduled (what guided fit(engine='fused') dispatches by
    default under shuffle+decay) on a (4 data x 2 param) mesh with the
    epoch_batch_constraint: trajectory identical to single-device."""
    from stochqn_tpu.parallel import epoch_batch_constraint

    n, n_rows, bs, L, m, nepochs = 64, 64, 8, 2, 3, 3
    a_diag = jnp.asarray(rng.uniform(0.5, 2.0, n))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch[0], axis=0))

    cfg = SQNConfig.create(mem_size=m, bfgs_upd_freq=L)
    mesh = make_mesh(n_data=4, n_param=2)
    flat_x = jnp.asarray(rng.standard_normal((n_rows, n)))
    orders = jnp.asarray(np.stack([rng.permutation(n_rows)
                                   for _ in range(nepochs)]), jnp.int32)
    steps = jnp.asarray([0.05 / np.sqrt(e + 1.0) for e in range(nepochs)])

    tr_plain = FusedTrainer("SQN", cfg, grad_fn)
    st_plain, infos_plain = tr_plain.jit_epochs_scheduled()(
        tr_plain.init(jnp.zeros(n)), (flat_x,), steps, orders,
        batch_size=bs, aligned=True)

    tr_sh = FusedTrainer("SQN", cfg, grad_fn,
                         batch_constraint=epoch_batch_constraint(mesh))
    st0 = shard_state(tr_sh.init(jnp.zeros(n)), mesh)
    flat_sh = jax.device_put(
        flat_x, jax.NamedSharding(mesh,
                                  jax.sharding.PartitionSpec("data",
                                                             "param")))
    st_sh, infos_sh = tr_sh.jit_epochs_scheduled()(
        st0, (flat_sh,), steps, orders, batch_size=bs, aligned=True)

    np.testing.assert_allclose(np.asarray(st_sh.x), np.asarray(st_plain.x),
                               rtol=1e-8, atol=1e-10)
    assert np.array_equal(np.asarray(infos_sh), np.asarray(infos_plain))
    assert int(st_sh.niter) == nepochs * (n_rows // bs)


def test_scheduled_whole_fit_collective_depth_budget(rng):
    """The scheduled program's collective placement, locked by loop depth
    (op_name `while/body` nesting): the dataset-shard gather all-reduce
    runs once per EPOCH (depth 1), never inside the per-round (depth 2)
    or per-step (depth 3) loops; per-step payloads stay <= one gradient
    shard + O(m) smalls.  This is the 'GSPMD silently all-gathers per
    step' failure mode ruled out statically."""
    from stochqn_tpu.parallel import epoch_batch_constraint

    n, n_rows, bs, L, m, nepochs, p = 64, 64, 8, 2, 3, 3, 2
    a_diag = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch[0], axis=0))

    cfg = SQNConfig.create(mem_size=m, bfgs_upd_freq=L)
    mesh = make_mesh(n_data=4, n_param=p)
    tr = FusedTrainer("SQN", cfg, grad_fn,
                      batch_constraint=epoch_batch_constraint(mesh))
    st0 = shard_state(tr.init(jnp.zeros(n, jnp.float32)), mesh)
    flat_sh = jax.device_put(
        jnp.asarray(rng.standard_normal((n_rows, n)).astype(np.float32)),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec("data", "param")))
    orders = jnp.asarray(np.stack([rng.permutation(n_rows)
                                   for _ in range(nepochs)]), jnp.int32)
    steps = jnp.full((nepochs,), 0.05, jnp.float32)

    hlo = tr.jit_epochs_scheduled().lower(
        st0, (flat_sh,), steps, orders, batch_size=bs,
        aligned=True).compile().as_text()
    ops = collective_ops(hlo)
    assert ops and all(o.loop_depth >= 0 for o in ops), \
        "op_name metadata missing - cannot attribute loop depth"

    grad_shard = n * 4 // p
    dataset_shard = n_rows * (n // p) * 4
    big = [o for o in ops if o.payload_bytes > grad_shard + 256]
    # exactly one dataset-sized collective, and it is per-epoch (depth 1)
    assert len(big) == 1, [(o.payload_bytes, o.loop_depth) for o in big]
    assert big[0].loop_depth <= 1, big[0]
    assert big[0].payload_bytes <= dataset_shard + 256, big[0]
    # everything inside the per-round/per-step loops is small
    for o in ops:
        if o.loop_depth >= 2:
            assert o.payload_bytes <= grad_shard + 256, o


def test_collective_bytes_bf16_interleaved_olbfgs_param_sharded(rng):
    """bf16 + interleaved [2m, n] pair storage under a param-only mesh:
    the in-matmul f32 upcast (ops/two_loop._mem_mm) must stay
    collective-free — the per-step payload is O(m) scalars, NOT the
    bf16 pair buffer.  Also locks sharded == unsharded trajectories."""
    import functools
    from stochqn_tpu.core.config import OLBFGSConfig
    from stochqn_tpu.fused import olbfgs_step

    n, bs, m = 4096, 8, 3
    mesh = make_mesh(n_data=1, n_param=8)
    a_diag = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch, axis=0))

    cfg = OLBFGSConfig.create(mem_size=m, min_curvature=1e-8,
                              pairs_bf16=True, pairs_interleaved=True)
    tr = FusedTrainer("oLBFGS", cfg, grad_fn)
    data = jnp.asarray(rng.standard_normal((4, bs, n)).astype(np.float32))
    st = tr.init(jnp.zeros(n, jnp.float32))
    st, _ = tr.epoch(st, data, 0.05)          # warm: pairs committed
    st_sh = shard_state(st, mesh)
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "param")))

    fn = jax.jit(functools.partial(olbfgs_step, cfg, grad_fn))
    hlo = fn.lower(st_sh, batch, jnp.float32(0.05)).compile().as_text()
    ops = collective_ops(hlo)
    total = sum(o.payload_bytes for o in ops)
    assert 0 < total <= 1024, (total, [(o.kind, o.payload_bytes)
                                       for o in ops])
    assert total < n, "bf16 param-sharded step moved O(n) bytes"

    # trajectory: one more epoch, sharded vs unsharded (bf16-storage
    # rounding is identical; only float reduction order may differ)
    st_ref, _ = jax.jit(tr.epoch)(st, data, 0.05)
    st_shd, _ = jax.jit(tr.epoch)(st_sh, data, 0.05)
    np.testing.assert_allclose(np.asarray(st_shd.x), np.asarray(st_ref.x),
                               rtol=1e-3, atol=1e-4)


def test_collective_bytes_bf16_fisher_adaqn_param_sharded(rng):
    """adaQN with bf16 pair AND Fisher storage on the param-only mesh:
    per-step (Fisher ring append + preconditioned two-loop) and boundary
    (Fisher gemvs F^T(F s) + guard + commit) payloads both stay O(m) —
    the [fisher_size, n] bf16 buffer never crosses the mesh."""
    import functools
    from stochqn_tpu.core.config import AdaQNConfig
    from stochqn_tpu.fused import _adaqn_base, _adaqn_boundary

    n, bs, m, L = 4096, 8, 3, 4
    mesh = make_mesh(n_data=1, n_param=8)
    a_diag = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch, axis=0))

    def obj_fn(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * jnp.vdot(r, a_diag * r)

    cfg = AdaQNConfig.create(mem_size=m, bfgs_upd_freq=L, fisher_size=4,
                             max_incr=1.01, rmsprop_weight=0.9,
                             pairs_bf16=True, fisher_bf16=True)
    tr = FusedTrainer("adaQN", cfg, grad_fn, obj_fn=obj_fn)
    data = jnp.asarray(rng.standard_normal((4, bs, n)).astype(np.float32))
    st = tr.init(jnp.zeros(n, jnp.float32))
    st, _ = tr.epoch(st, data, 0.05)
    st_sh = shard_state(st, mesh)
    spec = jax.sharding.PartitionSpec(None, "param")
    batch = jax.device_put(
        jnp.asarray(rng.standard_normal((bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, spec))

    fn = jax.jit(functools.partial(_adaqn_base, cfg, grad_fn))
    hlo = fn.lower(st_sh, batch, jnp.float32(0.05)).compile().as_text()
    step_total = collective_bytes(hlo)
    assert 0 < step_total <= 1024, step_total

    big = jax.device_put(
        jnp.asarray(rng.standard_normal((L * bs, n)).astype(np.float32)),
        jax.NamedSharding(mesh, spec))
    bfn = jax.jit(functools.partial(_adaqn_boundary, cfg, grad_fn, obj_fn))
    bhlo = bfn.lower(st_sh, big, big, jnp.zeros((), bool)).compile().as_text()
    btotal = collective_bytes(bhlo)
    assert 0 < btotal <= 1024, btotal


def test_sparse_sqn_sharded_epoch_matches_and_budget(rng):
    """Padded-COO sparse gradients under (4 data x 2 param): the
    scatter-add lowers to a LOCAL scatter into each device's param shard
    + one gradient-shard all-reduce over the data axis — no O(n_rows)
    gather, no full-gradient broadcast.  Trajectory matches unsharded."""
    import functools
    from stochqn_tpu.fused import _sqn_base
    from stochqn_tpu.models.sparse import (csr_to_padded,
                                           sparse_multinomial_logistic_grad)

    nf, C, k, bs, B, L, m, p = 256, 4, 8, 16, 8, 4, 3, 2
    n = (nf + 1) * C
    mesh = make_mesh(n_data=4, n_param=p)

    def grad_fn(x, batch):
        idx, val, Y = batch
        return sparse_multinomial_logistic_grad(x, idx, val, Y, nf,
                                                reg_param=1e-1)

    cfg = SQNConfig.create(mem_size=m, bfgs_upd_freq=L)
    tr = FusedTrainer("SQN", cfg, grad_fn)

    dense = np.zeros((B * bs, nf), np.float32)
    for r in range(B * bs):
        cols = rng.choice(nf, size=k // 2, replace=False)
        dense[r, cols] = rng.standard_normal(k // 2)
    idx, val = csr_to_padded(dense, max_nnz=k)
    labels = rng.integers(0, C, size=B * bs)
    hot = np.eye(C, dtype=np.float32)[labels]
    data = (jnp.asarray(idx.reshape(B, bs, k)),
            jnp.asarray(val.reshape(B, bs, k)),
            jnp.asarray(hot.reshape(B, bs, C)))

    x0 = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    st_plain, infos_plain = jax.jit(tr.epoch)(tr.init(x0), data, 0.05)

    st_sh = shard_state(tr.init(x0), mesh)
    data_sh = shard_batches(data, mesh)
    st_sh2, infos_sh = jax.jit(tr.epoch)(st_sh, data_sh, 0.05)
    np.testing.assert_allclose(np.asarray(st_sh2.x),
                               np.asarray(st_plain.x),
                               rtol=1e-5, atol=1e-6)
    assert np.array_equal(np.asarray(infos_sh), np.asarray(infos_plain))
    assert int(st_sh2.niter) == B

    batch = jax.tree_util.tree_map(lambda a: a[0], data_sh)
    fn = jax.jit(functools.partial(_sqn_base, cfg, grad_fn))
    hlo = fn.lower(st_sh, batch, jnp.float32(0.05)).compile().as_text()
    total = collective_bytes(hlo)
    shard_bytes = n * 4 // p
    assert shard_bytes <= total <= shard_bytes + 1024, (
        total, [(o.kind, o.payload_bytes) for o in collective_ops(hlo)])


def test_hlo_stats_loop_depth_from_op_name():
    """loop_depth counts `while/body` segments in op_name metadata; ops
    without metadata report -1 (unknown)."""
    from stochqn_tpu.parallel.hlo_stats import collective_ops

    hlo = "\n".join([
        '  %a = f32[8]{0} all-reduce(%p), replica_groups=[1,8]<=[8], '
        'metadata={op_name="jit(run)/while/body/closed_call/while/body/'
        'closed_call/while/body/closed_call/dot_general"}',
        '  %b = f32[64]{0} all-reduce(%q), replica_groups=[2,4]<=[8], '
        'metadata={op_name="jit(run)/while/body/closed_call/gather"}',
        '  %c = f32[4]{0} all-reduce(%r), replica_groups=[1,8]<=[8]',
    ])
    depths = [(o.payload_bytes, o.loop_depth) for o in collective_ops(hlo)]
    assert (8 * 4, 3) in depths
    assert (64 * 4, 1) in depths
    assert (4 * 4, -1) in depths
