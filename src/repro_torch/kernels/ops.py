"""Public wrappers over the ported kernels (port of
``repro/kernels/ops.py``, K1 and K2).

There is no ``impl`` switch: each kernel module runs its CUDA kernel for
tensors on the card and its plain version for tensors on the CPU.
"""
from __future__ import annotations

from repro_torch.kernels.fusion_conv import fusion_conv
from repro_torch.kernels.mk_mmd import gram_sum


def mk_mmd2(x, y, widths):
    """Multi-kernel squared MMD between feature batches x [n,d], y [m,d]:
    three Gram sums (xx, yy, xy) at the median-heuristic sigma."""
    x = x.float().contiguous()
    y = y.float().contiguous()
    n, m = x.shape[0], y.shape[0]
    # stop-grad mean of the cross squared distances, as in the oracle
    x2 = (x * x).sum(-1)
    y2 = (y * y).sum(-1)
    dxy = x2[:, None] + y2[None, :] - 2 * (x @ y.T)
    sigma = dxy.mean().detach() + 1e-8
    sxx = gram_sum(x, x, sigma, widths)
    syy = gram_sum(y, y, sigma, widths)
    sxy = gram_sum(x, y, sigma, widths)
    return sxx / (n * n) + syy / (m * m) - 2.0 * sxy / (n * m)


def fused_fusion_conv(f_g, f_l, w):
    """FedFusion conv operator: W . concat(f_g, f_l) along channels."""
    return fusion_conv(f_g.contiguous(), f_l.contiguous(), w.contiguous())
