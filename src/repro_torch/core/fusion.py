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
from repro_torch.parallel import copy_to_model, gather_from_model, model_dim
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


def fusion_apply(op: str, params, f_g, f_l, tp=None):
    """The fused features.  Tensor-parallel (``tp`` a
    :class:`repro_torch.parallel.TensorParallel` of more than one rank, the
    streams replicated): ``conv``'s W [2C, C] split on its columns (its
    spec ``tp.specs["fusion"]["w"]``; the JAX layouts' generic ``w`` rule
    splits it where m divides C) runs K2 on this rank's block [2C, C/m],
    and the blocks are gathered over ``model``; a W left whole, and the
    gates, run whole on every rank.  Either way the result feeds a head
    split on V as it is (its gradient, which arrives in rank-dependent
    parts, is summed here)."""
    if tp is None or not tp.active:
        if op == "conv":
            return ops.fused_fusion_conv(f_g, f_l, params["w"])
        lam = params["lam"]
        return lam * f_g + (1.0 - lam) * f_l
    mp = tp.mp
    if op == "conv":
        if model_dim(tp.specs["fusion"]["w"]) == 1:
            block = ops.fused_fusion_conv(copy_to_model(f_g, mp),
                                          copy_to_model(f_l, mp),
                                          params["w"])
            return gather_from_model(block, -1, mp)
        return copy_to_model(ops.fused_fusion_conv(f_g, f_l, params["w"]),
                             mp)
    lam = params["lam"]
    return copy_to_model(lam * f_g + (1.0 - lam) * f_l, mp)


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
