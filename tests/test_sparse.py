"""Sparse (padded-COO) logistic losses: parity with the dense closed forms,
conversion round-trips, and end-to-end fused training on CTR-shaped data.

The reference's sparse surface: CSR input accepted by the logistic model
(``stochqn/_logistic.py:36-247``) and sparse vstack in the guided driver
(``stochqn/_optimizers.py:81-112``).  Here sparsity is a first-class batch
format for the JAX engines instead of a host-side densify."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from stochqn_tpu.models import losses
from stochqn_tpu.models.sparse import (
    csr_to_padded,
    sparse_binary_logistic_grad,
    sparse_binary_logistic_hessvec,
    sparse_binary_logistic_loss,
    sparse_binary_logistic_predict_proba,
    sparse_multinomial_logistic_grad,
    sparse_multinomial_logistic_hessvec,
    sparse_multinomial_logistic_loss,
    sparse_multinomial_logistic_predict_proba,
)


def _random_csr(rng, b, nf, density=0.1):
    return sp.random(b, nf, density=density, format="csr",
                     random_state=np.random.RandomState(rng.integers(1 << 30)),
                     data_rvs=lambda k: rng.standard_normal(k))


def test_csr_to_padded_roundtrip(rng):
    X = _random_csr(rng, 13, 40, density=0.2)
    idx, val = csr_to_padded(X, dtype=np.float64)
    assert idx.shape == val.shape and idx.dtype == np.int32
    assert idx.shape[1] % 8 == 0
    dense = np.zeros((13, 40))
    for r in range(13):
        np.add.at(dense[r], idx[r], val[r])
    np.testing.assert_allclose(dense, X.toarray(), rtol=1e-12)


def test_csr_to_padded_dense_input_and_cap(rng):
    X = rng.standard_normal((5, 12))
    idx, val = csr_to_padded(X, dtype=np.float64)
    dense = np.zeros_like(X)
    for r in range(5):
        np.add.at(dense[r], idx[r], val[r])
    np.testing.assert_allclose(dense, X)
    # max_nnz cap keeps largest-magnitude entries
    idx2, val2 = csr_to_padded(X, max_nnz=3, dtype=np.float64)
    assert idx2.shape == (5, 3)
    for r in range(5):
        top = np.sort(np.argsort(-np.abs(X[r]))[:3])
        np.testing.assert_array_equal(np.sort(idx2[r]), top)
    with pytest.raises(ValueError):
        csr_to_padded(X, max_nnz=0)


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_binary_sparse_dense_parity(rng, intercept, weighted):
    b, nf, reg = 17, 29, 0.37
    X = _random_csr(rng, b, nf, density=0.15)
    Xd = jnp.asarray(X.toarray())
    idx, val = csr_to_padded(X, dtype=np.float64)
    idx, val = jnp.asarray(idx), jnp.asarray(val)
    y = jnp.asarray(rng.integers(0, 2, b) * 2.0 - 1.0)
    sw = jnp.asarray(rng.uniform(0.5, 1.5, b)) if weighted else None
    w = jnp.asarray(rng.standard_normal(nf + intercept))
    v = jnp.asarray(rng.standard_normal(nf + intercept))

    np.testing.assert_allclose(
        sparse_binary_logistic_loss(w, idx, val, y, nf, sw, reg),
        losses.binary_logistic_loss(w, Xd, y, sw, reg), rtol=1e-12)
    np.testing.assert_allclose(
        sparse_binary_logistic_grad(w, idx, val, y, nf, sw, reg),
        losses.binary_logistic_grad(w, Xd, y, sw, reg), rtol=1e-10,
        atol=1e-12)
    np.testing.assert_allclose(
        sparse_binary_logistic_hessvec(w, v, idx, val, y, nf, sw, reg),
        losses.binary_logistic_hessvec(w, v, Xd, y, sw, reg), rtol=1e-10,
        atol=1e-12)
    np.testing.assert_allclose(
        sparse_binary_logistic_predict_proba(w, idx, val, nf),
        losses.binary_logistic_predict_proba(w, Xd), rtol=1e-12)


@pytest.mark.parametrize("intercept", [True, False])
def test_multinomial_sparse_dense_parity(rng, intercept):
    b, nf, k, reg = 11, 23, 5, 0.21
    X = _random_csr(rng, b, nf, density=0.2)
    Xd = jnp.asarray(X.toarray())
    idx, val = csr_to_padded(X, dtype=np.float64)
    idx, val = jnp.asarray(idx), jnp.asarray(val)
    Y = jnp.asarray(np.eye(k)[rng.integers(0, k, b)])
    sw = jnp.asarray(rng.uniform(0.5, 1.5, b))
    w = jnp.asarray(rng.standard_normal(k * (nf + intercept)))
    v = jnp.asarray(rng.standard_normal(k * (nf + intercept)))

    np.testing.assert_allclose(
        sparse_multinomial_logistic_loss(w, idx, val, Y, nf, sw, reg),
        losses.multinomial_logistic_loss(w, Xd, Y, sw, reg), rtol=1e-12)
    np.testing.assert_allclose(
        sparse_multinomial_logistic_grad(w, idx, val, Y, nf, sw, reg),
        losses.multinomial_logistic_grad(w, Xd, Y, sw, reg), rtol=1e-9,
        atol=1e-12)
    np.testing.assert_allclose(
        sparse_multinomial_logistic_hessvec(w, v, idx, val, Y, nf, sw, reg),
        losses.multinomial_logistic_hessvec(w, v, Xd, Y, sw, reg), rtol=1e-9,
        atol=1e-12)
    np.testing.assert_allclose(
        sparse_multinomial_logistic_predict_proba(w, idx, val, nf, k),
        losses.multinomial_logistic_predict_proba(w, Xd, k), rtol=1e-12)


def test_sparse_grad_matches_autodiff(rng):
    """The hand-written scatter gradient equals jax.grad of the loss —
    locks the gather/scatter algebra independently of the dense forms."""
    b, nf = 9, 21
    X = _random_csr(rng, b, nf, density=0.25)
    idx, val = csr_to_padded(X, dtype=np.float64)
    idx, val = jnp.asarray(idx), jnp.asarray(val)
    y = jnp.asarray(rng.integers(0, 2, b) * 2.0 - 1.0)
    w = jnp.asarray(rng.standard_normal(nf + 1))
    g_auto = jax.grad(
        lambda ww: sparse_binary_logistic_loss(ww, idx, val, y, nf,
                                               None, 0.11))(w)
    g_ours = sparse_binary_logistic_grad(w, idx, val, y, nf, None, 0.11)
    np.testing.assert_allclose(g_ours, g_auto, rtol=1e-10, atol=1e-12)


def test_fused_sqn_on_sparse_ctr_batches(rng):
    """End-to-end: fused SQN training over padded-COO batches (the
    Criteo-shaped configuration, BASELINE config 5) — loss decreases and
    the engine never materializes a dense [B, n_features] matrix."""
    from stochqn_tpu.core.config import SQNConfig
    from stochqn_tpu.fused import FusedTrainer

    nf, b, nb, k = 4096, 32, 8, 8
    w_true = np.zeros(nf)
    hot = rng.choice(nf, 64, replace=False)
    w_true[hot] = rng.standard_normal(64) * 2.0

    idx = rng.integers(0, nf, (nb, b, k)).astype(np.int32)
    val = rng.standard_normal((nb, b, k))
    z = np.einsum("nbk,nbk->nb", val,
                  np.take(w_true, idx))
    y = np.where(rng.uniform(size=z.shape) < 1 / (1 + np.exp(-z)), 1.0, -1.0)

    idx_j, val_j, y_j = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)

    def grad_fn(x, batch):
        bi, bv, by = batch
        return sparse_binary_logistic_grad(x, bi, bv, by, nf, None, 1e-3)

    def obj_fn(x, batch):
        bi, bv, by = batch
        return sparse_binary_logistic_loss(x, bi, bv, by, nf, None, 1e-3)

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=5, bfgs_upd_freq=4,
                                use_grad_diff=True), grad_fn, obj_fn=obj_fn)
    state = trainer.init(jnp.zeros(nf))
    epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))

    def total_loss(x):
        return float(sum(obj_fn(x, (idx_j[i], val_j[i], y_j[i]))
                         for i in range(nb)))

    l0 = total_loss(state.x)
    for _ in range(6):
        state, infos = epoch(state, (idx_j, val_j, y_j), jnp.float32(0.5),
                             aligned=True)
    l1 = total_loss(state.x)
    assert np.isfinite(l1) and l1 < 0.7 * l0, (l0, l1)


def test_logistic_model_sparse_fused(rng):
    """StochasticLogisticRegression(engine='fused') with scipy CSR input
    trains through the padded-COO path without densifying the feature
    matrix on device."""
    from stochqn_tpu.models.logistic import StochasticLogisticRegression

    nf, n = 512, 600
    X = _random_csr(rng, n, nf, density=0.05)
    w_true = rng.standard_normal(nf)
    y = (X @ w_true + 0.1 * rng.standard_normal(n) > 0).astype(np.float64)

    clf = StochasticLogisticRegression(
        reg_param=1e-4, optimizer="SQN", step_size=1.0, valset_frac=None,
        nepochs=10, batches_per_epoch=10, engine="fused", random_state=3,
        dtype=np.float64)
    clf.fit(X, y)
    acc = (clf.predict(X) == y).mean()
    assert acc > 0.85, acc
    proba = clf.predict_proba(X[:5])
    assert proba.shape == (5, 2)


def test_protocol_engine_sparse_pins_padded_width(rng):
    """fit() derives the padded-COO width k from the FULL matrix so every
    batch compiles to the same [B, k] shape, and the conversion result is
    memoized on the batch object."""
    from stochqn_tpu.models.logistic import (StochasticLogisticRegression,
                                             _padded)

    nf, n = 64, 120
    X = _random_csr(rng, n, nf, density=0.1)
    w_true = rng.standard_normal(nf)
    y = (X @ w_true > 0).astype(np.float64)

    clf = StochasticLogisticRegression(
        reg_param=1e-4, optimizer="SQN", step_size=0.5, valset_frac=None,
        nepochs=2, batches_per_epoch=4, engine="protocol", random_state=0,
        use_grad_diff=True)
    clf.fit(X, y)
    max_nnz = int(np.diff(X.tocsr().indptr).max())
    assert clf._pad_k is not None and clf._pad_k >= max_nnz
    assert clf._pad_k % 8 == 0
    # pinned width: batches of different sparsity give the same k
    idx_a, _ = _padded(X[:10].tocsr(), np.float64, clf._pad_k)
    idx_b, _ = _padded(X[10:13].tocsr(), np.float64, clf._pad_k)
    assert idx_a.shape[1] == idx_b.shape[1] == clf._pad_k
    # memoization: same object + same (dtype, k) returns the cached arrays
    Xb = X[:10].tocsr()
    first = _padded(Xb, np.float64, clf._pad_k)
    second = _padded(Xb, np.float64, clf._pad_k)
    assert first[0] is second[0] and first[1] is second[1]


def test_padded_pinned_width_never_truncates(rng):
    """A batch denser than the pinned width (e.g. partial_fit data after an
    earlier fit) must widen, not silently drop features."""
    from scipy import sparse as sp
    from stochqn_tpu.models.logistic import _padded

    dense = np.zeros((4, 32))
    dense[0, :20] = 1.0          # 20 nnz in one row
    Xb = sp.csr_matrix(dense)
    idx, val = _padded(Xb, np.float64, 8)   # pinned width smaller than 20
    assert idx.shape[1] >= 20
    # all 20 features survive
    row_nnz = int((np.asarray(val)[0] != 0).sum())
    assert row_nnz == 20
