"""Free-mode request loop on the Rosenbrock function.

The Python equivalent of the reference's ``example/c_rosen.c`` workflow:
the user owns the evaluation loop, the optimizer answers with requests.
Works with either the JAX backend or the native C++ backend
(``--backend native``).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax

# A 2-parameter host-driven request loop gains nothing from an
# accelerator and pays a device round trip per protocol call — pin CPU.
# The on-device execution mode is the fused engine: see
# fused_training.py.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)   # match the reference's f64

import numpy as np

from stochqn_tpu import SQN_free, oLBFGS_free


def rosen(x):
    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1.0 - x[:-1]) ** 2))


def rosen_grad(x):
    g = np.zeros_like(x)
    g[:-1] = -400 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200 * (x[1:] - x[:-1] ** 2)
    return g


def rosen_hessvec(x, v, eps=1e-7):
    return (rosen_grad(x + eps * v) - rosen_grad(x - eps * v)) / (2 * eps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", choices=["oLBFGS", "SQN"],
                    default="oLBFGS")
    ap.add_argument("--backend", choices=["jax", "native"], default="jax")
    ap.add_argument("--step-size", type=float, default=2.5e-3)
    ap.add_argument("--max-evals", type=int, default=50000)
    args = ap.parse_args()

    x = np.array([-1.2, 1.0])
    if args.optimizer == "oLBFGS":
        opt = oLBFGS_free(mem_size=7, backend=args.backend)
    else:
        opt = SQN_free(mem_size=7, bfgs_upd_freq=4, backend=args.backend)

    req = opt.run_optimizer(x, args.step_size)
    for evals in range(args.max_evals):
        task = req["task"]
        if task in ("calc_grad", "calc_grad_same_batch",
                    "calc_grad_big_batch"):
            opt.update_gradient(rosen_grad(np.asarray(req["requested_on"])))
        elif task == "calc_hess_vec":
            xr, vr = req["requested_on"]
            opt.update_hess_vec(rosen_hessvec(np.asarray(xr), np.asarray(vr)))
        req = opt.run_optimizer(x, args.step_size)
        if np.abs(rosen_grad(x)).max() < 1e-6:
            break

    print(f"{args.optimizer} ({args.backend}): "
          f"x = ({x[0]:.6f}, {x[1]:.6f}), f = {rosen(x):.3e}, "
          f"{req['info']['iteration_number']} iterations")


if __name__ == "__main__":
    main()
