"""Layer primitives of the port (``repro/models/layers.py:dense_init``)."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale=None):
    """Truncated-normal (±2σ) fan-in init (LeCun-style), drawn on the CPU
    from ``generator``.  Same distribution as the JAX init; the numbers
    differ, since torch and ``jax.random`` are different generators."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)
