"""Pluggable federated algorithms (port of ``repro.fl.api``'s registry)."""
from repro_torch.fl.api.algorithm import (Algorithm, make_algorithm,
                                          register_algorithm,
                                          registered_algorithms)

__all__ = ["Algorithm", "make_algorithm", "register_algorithm",
           "registered_algorithms"]
