"""stochqn_tpu — stochastic limited-memory quasi-Newton optimizers in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the stochQN
reference library (oLBFGS, SQN, adaQN): request-driven free-mode protocol,
scikit-learn-style guided fitting, a fully fused on-device training engine,
data- and parameter-sharded multi-chip execution, and built-in models.
"""
from stochqn_tpu._version import __version__

from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.core.enums import Info, Task
from stochqn_tpu.core.state import (AdaQNState, BFGSMemory, FisherMemory,
                                    OLBFGSState, SQNState)
from stochqn_tpu.free import SQN_free, adaQN_free, oLBFGS_free

# Guided (scikit-learn-like) layer and models are imported lazily-ish here;
# they only depend on numpy/jax.
from stochqn_tpu.api import MinimizeResult, minimize
from stochqn_tpu.fused import FusedTrainer, batchify
from stochqn_tpu.guided import SQN, adaQN, oLBFGS
from stochqn_tpu.models.logistic import StochasticLogisticRegression

__all__ = [
    "__version__",
    "Task", "Info",
    "OLBFGSConfig", "SQNConfig", "AdaQNConfig",
    "BFGSMemory", "FisherMemory",
    "OLBFGSState", "SQNState", "AdaQNState",
    "oLBFGS_free", "SQN_free", "adaQN_free",
    "oLBFGS", "SQN", "adaQN",
    "FusedTrainer", "batchify",
    "minimize", "MinimizeResult",
    "StochasticLogisticRegression",
]
