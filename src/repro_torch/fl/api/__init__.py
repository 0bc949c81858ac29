"""Pluggable federated algorithms and the trainer facade (port of
``repro.fl.api``)."""
from repro_torch.fl.api.algorithm import (Algorithm, make_algorithm,
                                          register_algorithm,
                                          registered_algorithms)
from repro_torch.fl.api.trainer import (CheckpointOptions, EngineOptions,
                                        EvalOptions, FederatedTrainer,
                                        RunOptions)

__all__ = ["Algorithm", "make_algorithm", "register_algorithm",
           "registered_algorithms", "CheckpointOptions", "EngineOptions",
           "EvalOptions", "FederatedTrainer", "RunOptions"]
