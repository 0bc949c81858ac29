"""Plain PyTorch oracles for the ported kernels (port of
``repro/kernels/ref.py``, K1 and K2).  They define the semantics the
kernels and :mod:`repro_torch.kernels.ops` are held to; the per-kernel
plain versions live beside each kernel (``gram_sum_plain``,
``fusion_conv_plain``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fusion_conv import fusion_conv_plain

__all__ = ["mk_mmd2_ref", "fusion_conv_ref"]


def mk_mmd2_ref(x, y, widths, *, median_heuristic=True):
    """Multi-kernel squared MMD, biased V-statistic (paper Eq. 2):
    E[K(x,x)] + E[K(y,y)] - 2 E[K(x,y)], K the mean of RBF kernels
    exp(-||a-b||^2 / (2 w sigma)), sigma the stop-grad mean cross squared
    distance."""
    x = x.float()
    y = y.float()

    def sqdist(a, b):
        return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                - 2.0 * (a @ b.T))

    dxx, dyy, dxy = sqdist(x, x), sqdist(y, y), sqdist(x, y)
    sigma = dxy.mean().detach() + 1e-8 if median_heuristic else 1.0

    def kmean(d2):
        k = sum(torch.exp(-d2 / (2.0 * w * sigma)) for w in widths)
        return k.mean() / len(widths)

    return kmean(dxx) + kmean(dyy) - 2.0 * kmean(dxy)


fusion_conv_ref = fusion_conv_plain
