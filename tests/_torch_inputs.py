"""Seeded numpy inputs and reduced configs shared by the port's tests (no
JAX here: ``test_torch_cuda.py`` runs on the GPU host, which has none)."""
import dataclasses

import numpy as np

WIDTHS = (1.0, 2.0, 4.0, 8.0, 16.0)
# ``ArchConfig.reduced()`` sets head_dim = d_model // n_heads = 64; these
# configs keep the head dim the attention kernels are built for
OWN_HEAD_DIMS = {"stablelm-3b": 80, "h2o-danube-3-4b": 120}


def reduced(cfg, **changes):
    """``cfg.reduced()`` (a JAX or a port config) at the config's own head
    dim where that is not 64, with ``changes`` applied."""
    if cfg.name in OWN_HEAD_DIMS:
        changes.setdefault("head_dim", OWN_HEAD_DIMS[cfg.name])
    return dataclasses.replace(cfg.reduced(), **changes)


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
