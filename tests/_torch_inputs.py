"""Seeded numpy inputs shared by the port's kernel tests (no JAX here:
``test_torch_cuda.py`` runs on the GPU host, which has none)."""
import numpy as np

WIDTHS = (1.0, 2.0, 4.0, 8.0, 16.0)


def rng_pair(n, m, d, seed):
    """x [n, d] ~ N(0, 1) and y [m, d] ~ N(1, 0.25), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (0.5 * rng.standard_normal((m, d)) + 1.0).astype(np.float32)
    return x, y


def fusion_inputs(shape, C, seed):
    """f_g, f_l [*shape, C] ~ N(0, 1) and w [2C, C] ~ N(0, 1/2C), float32."""
    rng = np.random.default_rng(seed)
    fg = rng.standard_normal(shape + (C,)).astype(np.float32)
    fl = rng.standard_normal(shape + (C,)).astype(np.float32)
    w = (rng.standard_normal((2 * C, C)) / np.sqrt(2 * C)).astype(np.float32)
    return fg, fl, w
