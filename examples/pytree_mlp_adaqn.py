"""Training a pytree-parameterized model (flax/haiku style) with adaQN.

The reference shipped a TensorFlow-v1 adapter so its optimizers could sit
inside an ML framework's training loop (``/root/reference/stochqn/tf.py``).
The modern equivalent here is :class:`stochqn_tpu.optax_adapter.
PytreeTrainer`: give it any ``loss_fn(params_pytree, batch)`` and a
parameter template, and the full-fidelity fused engine (same-batch oLBFGS
pairs, SQN jvp Hessian-vector products, adaQN's function-value guard)
trains the pytree directly — the ravel/unravel to the optimizer's flat
``x[n]`` is handled internally.

Runs on CPU or GPU.  A two-layer tanh MLP on a synthetic two-moons-style
binary task; adaQN with the RMSProp-preconditioned two-loop and the
``max_incr`` guard active.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from stochqn_tpu.core.config import AdaQNConfig
from stochqn_tpu.optax_adapter import PytreeTrainer


def make_data(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    flip = rng.integers(0, 2, n)
    x = np.stack([np.cos(t) + flip * 1.0 - 0.5,
                  np.sin(t) * (1 - 2 * flip) + flip * 0.35], axis=1)
    x += rng.normal(scale=0.12, size=x.shape)
    return (jnp.asarray(x, jnp.float32),
            jnp.asarray(flip.astype(np.float32)))


def init_params(rng, hidden=32):
    k1, k2 = jax.random.split(rng)
    return {
        "dense1": {"w": jax.random.normal(k1, (2, hidden)) * 0.5,
                   "b": jnp.zeros(hidden)},
        "dense2": {"w": jax.random.normal(k2, (hidden, 1)) * 0.5,
                   "b": jnp.zeros(1)},
    }


def forward(params, x):
    h = jnp.tanh(x @ params["dense1"]["w"] + params["dense1"]["b"])
    return (h @ params["dense2"]["w"] + params["dense2"]["b"])[:, 0]


def loss_fn(params, batch):
    x, y = batch
    logits = forward(params, x)
    z = logits * (2 * y - 1)
    return jnp.mean(jnp.maximum(-z, 0) + jnp.log1p(jnp.exp(-jnp.abs(z))))


def main():
    x, y = make_data()
    params0 = init_params(jax.random.PRNGKey(0))

    bs, nb = 128, x.shape[0] // 128
    data = (x[:nb * bs].reshape(nb, bs, 2), y[:nb * bs].reshape(nb, bs))

    trainer = PytreeTrainer(
        "adaQN",
        AdaQNConfig.create(mem_size=10, fisher_size=50, bfgs_upd_freq=8,
                           max_incr=1.01, rmsprop_weight=0.9),
        loss_fn, params0)
    state = trainer.init()

    print(f"initial loss: {float(loss_fn(params0, (x, y))):.4f}")
    for epoch in range(12):
        # NOTE: run_epochs CONSUMES the state it is given (donated
        # buffers) — always rebind to the returned state.
        state, _ = trainer.run_epochs(state, data, 1, step_size=0.1)
        params = trainer.params(state)
        loss = float(loss_fn(params, (x, y)))
        acc = float(jnp.mean((forward(params, x) > 0) == (y > 0)))
        print(f"epoch {epoch + 1:2d}: loss {loss:.4f}  acc {acc:.3f}")

    assert acc > 0.9, "did not learn the moons"
    print("done — pytree params trained by the fused adaQN engine")


if __name__ == "__main__":
    main()
