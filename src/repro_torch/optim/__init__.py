"""Optimizers (in-place updates of a tree the caller owns) and learning-rate
schedules."""
from repro_torch.optim.optimizers import (adam_init, adam_update,
                                          make_optimizer, sgd_init,
                                          sgd_update)
from repro_torch.optim.schedules import exp_decay_per_round

__all__ = ["adam_init", "adam_update", "make_optimizer", "sgd_init",
           "sgd_update", "exp_decay_per_round"]
