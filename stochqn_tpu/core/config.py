"""Static (trace-time) hyperparameter records for the three optimizers.

These are hashable frozen dataclasses passed as static arguments to jitted
transition functions; everything runtime-variable lives in the state pytrees
(:mod:`stochqn_tpu.core.state`).

Defaults match the reference Python free-mode constructors
(``stochqn/_optimizers.py:966-967`` for oLBFGS, ``:1091-1092`` for SQN,
``:1249-1250`` for adaQN), with the reference's ``None -> 0`` sentinel
normalization (``stochqn/_optimizers.py:883-908``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _check_coupling(value: str) -> str:
    if value not in ("matvec", "gram"):
        raise ValueError(f"'coupling' must be 'matvec' or 'gram', "
                         f"got {value!r}")
    return value


def _norm(value: Optional[float], name: str, positive: bool = True) -> float:
    """Reference semantics: ``None`` means "feature off" and maps to 0."""
    if value is None:
        return 0.0
    value = float(value)
    if positive and value <= 0:
        raise ValueError(f"'{name}' must be positive or None, got {value!r}")
    return value


@dataclasses.dataclass(frozen=True)
class OLBFGSConfig:
    """oLBFGS hyperparameters (Schraudolph et al., 2007).

    Reference: ``initialize_oLBFGS`` at ``src/stochqn.c:464-481`` and the
    Python wrapper ``oLBFGS_free`` at ``stochqn/_optimizers.py:929-973``.
    """

    mem_size: int = 10
    hess_init: float = 0.0      # 0 -> gamma = s.y/y.y of the latest pair
    min_curvature: float = 1e-4  # 0 -> accept every pair
    y_reg: float = 0.0           # y += y_reg * s
    check_nan: bool = True
    # Store the (s, y) ring in bfloat16 (float32 math): halves the pair
    # memory's bytes for large n at a small accuracy cost.
    pairs_bf16: bool = False
    # Store the ring as one flat [2m, n] buffer (rows [s_0, y_0, s_1,
    # ...]): each per-iteration commit is then ONE contiguous [2, n] write
    # instead of two [n] row writes — targeted at oLBFGS's every-iteration
    # commits (see core.state.BFGSMemoryInterleaved; not measured on the
    # H100).  Same trajectories to float tolerance (the final expansion
    # contracts the 2m rows in a different order).
    pairs_interleaved: bool = False

    # oLBFGS produces one correction pair per iteration.
    upd_freq: int = 1

    @classmethod
    def create(cls, mem_size=10, hess_init=None, min_curvature=1e-4,
               y_reg=None, check_nan=True, pairs_bf16=False,
               pairs_interleaved=False) -> "OLBFGSConfig":
        if mem_size <= 0:
            raise ValueError("'mem_size' must be a positive integer")
        return cls(
            mem_size=int(mem_size),
            hess_init=_norm(hess_init, "hess_init"),
            min_curvature=_norm(min_curvature, "min_curvature"),
            y_reg=_norm(y_reg, "y_reg"),
            check_nan=bool(check_nan),
            pairs_bf16=bool(pairs_bf16),
            pairs_interleaved=bool(pairs_interleaved),
        )


@dataclasses.dataclass(frozen=True)
class SQNConfig:
    """SQN hyperparameters (Byrd et al., 2016).

    Reference: ``initialize_SQN`` at ``src/stochqn.c:483-506`` and
    ``SQN_free`` at ``stochqn/_optimizers.py:1048-1097``.
    """

    mem_size: int = 10
    upd_freq: int = 20           # "bfgs_upd_freq" L: pair every L iterations
    min_curvature: float = 1e-4
    y_reg: float = 0.0
    use_grad_diff: bool = False  # False -> Hessian-vector products
    check_nan: bool = True
    pairs_bf16: bool = False     # see OLBFGSConfig.pairs_bf16
    pairs_interleaved: bool = False  # see OLBFGSConfig.pairs_interleaved

    @classmethod
    def create(cls, mem_size=10, bfgs_upd_freq=20, min_curvature=1e-4,
               y_reg=None, use_grad_diff=False, check_nan=True,
               pairs_bf16=False, pairs_interleaved=False) -> "SQNConfig":
        if mem_size <= 0 or bfgs_upd_freq <= 0:
            raise ValueError("'mem_size' and 'bfgs_upd_freq' must be positive")
        return cls(
            mem_size=int(mem_size),
            upd_freq=int(bfgs_upd_freq),
            min_curvature=_norm(min_curvature, "min_curvature"),
            y_reg=_norm(y_reg, "y_reg"),
            use_grad_diff=bool(use_grad_diff),
            check_nan=bool(check_nan),
            pairs_bf16=bool(pairs_bf16),
            pairs_interleaved=bool(pairs_interleaved),
        )


@dataclasses.dataclass(frozen=True)
class AdaQNConfig:
    """adaQN hyperparameters (Keskar & Berahas, 2016).

    Reference: ``initialize_adaQN`` at ``src/stochqn.c:508-547`` and
    ``adaQN_free`` at ``stochqn/_optimizers.py:1192-1277``.

    ``h0_exact_reference``: the reference's ``diag_rescal`` writes the
    *rescaled gradient* ``g / sqrt(acc + scal_reg)`` into the diagonal-H0
    buffer used by the two-loop recursion (``src/stochqn.c:762-782,818``),
    rather than the RMSProp/AdaGrad diagonal ``1 / sqrt(acc + scal_reg)``
    described in the adaQN paper.  ``True`` (the default) reproduces the
    reference exactly; ``False`` uses the paper's diagonal.
    """

    mem_size: int = 10
    fisher_size: int = 100
    upd_freq: int = 20
    max_incr: float = 1.01       # 0 -> no function-value guard
    min_curvature: float = 1e-4
    scal_reg: float = 1e-4
    rmsprop_weight: float = 0.0  # 0 -> AdaGrad accumulator
    y_reg: float = 0.0
    use_grad_diff: bool = False  # False -> empirical Fisher for y
    check_nan: bool = True
    h0_exact_reference: bool = True
    pairs_bf16: bool = False     # see OLBFGSConfig.pairs_bf16
    fisher_bf16: bool = False    # bfloat16 Fisher gradient store (f32 math)
    # Diagonal-H0 coupling formulation (see ops/two_loop.two_loop_cached):
    # "matvec" (default) moves the fewest bytes on one device; "gram" keeps
    # the per-step psum count at one under a param-sharded n axis.
    coupling: str = "matvec"

    @classmethod
    def create(cls, mem_size=10, fisher_size=100, bfgs_upd_freq=20,
               max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
               rmsprop_weight=None, y_reg=None, use_grad_diff=False,
               check_nan=True, h0_exact_reference=True,
               pairs_bf16=False, fisher_bf16=False,
               coupling="matvec") -> "AdaQNConfig":
        if mem_size <= 0 or bfgs_upd_freq <= 0:
            raise ValueError("'mem_size' and 'bfgs_upd_freq' must be positive")
        # Reference: fisher_size=None forces use_grad_diff
        # (stochqn/_optimizers.py:773-774,1255-1259).
        if fisher_size is None:
            use_grad_diff = True
            fisher_size = 0
        elif not use_grad_diff and fisher_size <= 0:
            raise ValueError("'fisher_size' must be positive (or None)")
        if use_grad_diff:
            fisher_size = 0
        rw = 0.0 if rmsprop_weight is None else float(rmsprop_weight)
        if rmsprop_weight is not None and not (0.0 < rw < 1.0):
            raise ValueError("'rmsprop_weight' must be in (0, 1) or None")
        scal_reg = float(scal_reg)
        if scal_reg <= 0:
            raise ValueError("'scal_reg' must be positive")
        return cls(
            mem_size=int(mem_size),
            fisher_size=int(fisher_size),
            upd_freq=int(bfgs_upd_freq),
            max_incr=_norm(max_incr, "max_incr"),
            min_curvature=_norm(min_curvature, "min_curvature"),
            scal_reg=scal_reg,
            rmsprop_weight=rw,
            y_reg=_norm(y_reg, "y_reg"),
            use_grad_diff=bool(use_grad_diff),
            check_nan=bool(check_nan),
            h0_exact_reference=bool(h0_exact_reference),
            pairs_bf16=bool(pairs_bf16),
            fisher_bf16=bool(fisher_bf16),
            coupling=_check_coupling(coupling),
        )
