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


# K5's edge cases: the threshold a tie (an entry's |x|), 0, negative, +inf
TOPK_EDGE_T = ("tie", "zero", "negative", "inf")


def topk_edge_case(n, case):
    """x float32 [n] ~ N(0, 1) holding NaN, +-inf, -0.0, +0.0 and +-t (as
    many as n allows, a different set for each case when n < 7), and the
    threshold t of ``case`` (one of ``TOPK_EDGE_T``), as float32."""
    rng = np.random.default_rng(7 * n + len(case))
    x = rng.standard_normal(n).astype(np.float32)
    t = {"tie": np.sort(np.abs(x))[-(n + 1) // 2], "zero": np.float32(0),
         "negative": np.float32(-0.5), "inf": np.float32(np.inf)}[case]
    special = np.array([np.nan, np.inf, -np.inf, -0.0, t, -t, 0.0],
                       np.float32)
    m = min(n, special.size)
    at = rng.choice(n, size=m, replace=False)
    x[at] = np.roll(special, -TOPK_EDGE_T.index(case))[:m]
    return x, np.float32(t)
