"""Learning-rate schedules (port of ``repro/optim/schedules.py``).  The
paper uses a per-round exponential decay (0.985/round for artificial
non-IID, 0.99/round for permuted MNIST)."""
from __future__ import annotations

import torch


def exp_decay_per_round(base_lr: float, decay: float):
    """``lr_at(r) = base_lr * decay**r``, computed in float32 as the JAX
    schedule computes it."""
    def lr_at(round_idx):
        f32 = torch.float32
        return float(torch.tensor(base_lr, dtype=f32)
                     * torch.tensor(decay, dtype=f32)
                     ** torch.tensor(float(round_idx), dtype=f32))
    return lr_at
