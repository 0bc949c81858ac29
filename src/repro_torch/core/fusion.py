"""FedFusion feature-fusion modules (port of ``repro/core/fusion.py``;
paper §3.2).

Operators map (E_g(x), E_l(x)) in R^{...xC} x R^{...xC} -> R^{...xC}:
  conv   : W . concat(E_g, E_l) over channels, W in R^{2C x C}
  multi  : lam * E_g + (1 - lam) * E_l, learned per-channel lam in R^C
  single : scalar learned lam

The channel axis is the last axis (NHWC feature maps).  Aggregation:
`conv` weights average like any parameter; `multi`/`single` gates use an
exponential moving average (paper §3.3).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.tree import tree_map

FUSION_OPS = ("conv", "multi", "single")


def fusion_init(op: str, channels: int, generator: torch.Generator,
                dtype=torch.float32):
    """Fusion params on the generator's device."""
    if op == "conv":
        # initialise at "average the two streams": W = 0.5 * [I; I]
        eye = torch.eye(channels, dtype=dtype, device=generator.device)
        w = torch.cat([0.5 * eye, 0.5 * eye], dim=0)
        noise = dense_init(generator, (2 * channels, channels), dtype) * 0.01
        return {"w": w + noise}
    if op == "multi":
        return {"lam": torch.full((channels,), 0.5, dtype=dtype,
                                  device=generator.device)}
    if op == "single":
        return {"lam": torch.full((), 0.5, dtype=dtype,
                                  device=generator.device)}
    raise ValueError(op)


def fusion_apply(op: str, params, f_g, f_l):
    if op == "conv":
        return ops.fused_fusion_conv(f_g, f_l, params["w"])
    lam = params["lam"]
    return lam * f_g + (1.0 - lam) * f_l


def fusion_aggregate(op: str, old_global, client_fusions, weights, ema_beta,
                     shard=None):
    """Aggregate per-client fusion params returned after local training.

    ``client_fusions``: tree with a leading client axis; ``weights``
    [n_clients] sum to 1 over the round.  conv -> weighted average;
    multi/single -> EMA between the old global gate and the weighted
    client average.  ``shard``
    (:class:`repro_torch.core.aggregate.ClientSharding`): the client axis
    holds this rank's clients only; the weighted average is reduced here
    and completed with an all-reduce BEFORE the EMA, which must see the
    round's average once.
    """
    from repro_torch.core.aggregate import psum_tree
    avg = psum_tree(tree_map(
        lambda x: torch.tensordot(weights.to(x.dtype), x, dims=1),
        client_fusions), shard)
    if op == "conv":
        return avg
    return tree_map(lambda old, new: ema_beta * old + (1.0 - ema_beta) * new,
                    old_global, avg)
