"""Deterministic client-chaos injection: the public entry point (port of
``repro/chaos.py``).

The implementation lives with the data loader
(``repro_torch.data.federated``) because the fault schedule must ride the
dataset's rng streams to stay reproducible and resumable; this module is
the stable import surface:

    from repro_torch.chaos import ChaosConfig
    data = FederatedDataset(clients, test, seed=0,
                            chaos=ChaosConfig(speed_sigma=1.2, dropout=0.05))

Pair a chaos-enabled dataset with a participation policy
(``repro_torch.fl.participation``) to decide, per round, which of the
sampled clients contribute and at what staleness weight.
"""
from repro_torch.data.federated import ChaosConfig, ChaosDraws  # noqa: F401

__all__ = ["ChaosConfig", "ChaosDraws"]
