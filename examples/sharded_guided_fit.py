"""Sharded guided fit: ``fit(engine="fused", mesh=...)`` on a device mesh.

The guided scikit-learn-style driver (the reference's ``fit`` loop,
``stochqn/_optimizers.py:199-286``) runs as single on-device programs with
``engine="fused"``; passing a ``(data, param)`` mesh additionally shards
the optimizer state's parameter axis over ``param`` and every minibatch's
example axis over ``data`` — GSPMD inserts the gradient psums and the
two-loop's O(m^2) reductions from the sharding annotations alone.  With
per-epoch shuffling the WHOLE fit still compiles to one device program:
the composed row orders are precomputed host-side and gathered on device,
with ``parallel.epoch_batch_constraint`` keeping the gathered batches
data-parallel.

On a machine with several GPUs the same code spans them over NVLink; here
it runs on 8 virtual CPU devices so the example is self-contained.

Run: python examples/sharded_guided_fit.py
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# virtual 8-device mesh on CPU for a self-contained example; f64 so the
# sharded == unsharded comparison below is tight
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from stochqn_tpu.guided import SQN
from stochqn_tpu.parallel import make_mesh


def main():
    rng = np.random.default_rng(0)
    n_rows, n_features = 4000, 64
    X = rng.standard_normal((n_rows, n_features))
    w_true = rng.standard_normal(n_features)
    y = X @ w_true + 0.05 * rng.standard_normal(n_rows)

    def obj(w, Xb, yb, sample_weight=None, **kw):
        return 0.5 * np.mean((Xb @ w - yb) ** 2)

    def grad(w, Xb, yb, sample_weight=None, **kw):
        return Xb.T @ (Xb @ w - yb) / Xb.shape[0]

    # 4-way data parallel x 2-way parameter sharding
    mesh = make_mesh(n_data=4, n_param=2)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} over "
          f"{mesh.devices.size} devices")

    def make():
        return SQN(np.zeros(n_features), grad, obj_fun=obj,
                   use_grad_diff=True, step_size=0.2, batches_per_epoch=20,
                   bfgs_upd_freq=5, nepochs=10, verbose=False)

    opt = make()
    opt.fit(X, y, engine="fused", mesh=mesh)
    ref = make()
    ref.fit(X, y, engine="fused")           # same fit, unsharded

    final = obj(opt.x, X, y)
    print(f"dispatch mode: {opt._fused_dispatch_mode} "
          f"(whole fit = {'ONE device program' if opt._fused_single_dispatch else 'per-epoch programs'})")
    print(f"iterations: {opt.niter}, final loss {final:.6f}, "
          f"w error {np.linalg.norm(opt.x - w_true):.4f}")
    drift = np.max(np.abs(opt.x - ref.x))
    print(f"sharded vs unsharded max |dx|: {drift:.2e} "
          "(float reduction order only)")
    assert drift < 1e-8 and final < 0.05
    print("ok")


if __name__ == "__main__":
    main()
