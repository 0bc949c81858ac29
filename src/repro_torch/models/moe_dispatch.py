"""Expert-parallel MoE with an explicit all-to-all token dispatch (port of
``repro/models/moe_dispatch.py``).

Each ``data`` rank routes its OWN tokens, sends only its top-C picks per
expert to the expert's home rank with one all-to-all, runs its local
experts over everything it received, and sends the results back with the
reverse all-to-all; the gate weighting and the combine happen at the
source.  This is the JAX package's ``shard_map`` body, rank by rank:

    tokens   x      [T_loc, d]           (this rank's batch block)
    experts  w1/w2  [E_loc, ...]         (this rank's experts; E = n * E_loc)
    router          [d, E]               (replicated)

Per rank: route, per-expert top-C pick -> xe [E, C, d]; all-to-all over
``data`` -> [n, E_loc, C, d]; the local expert FFN over [E_loc, n*C, d]
(f split over ``model`` too where the specs say so: the results are summed
over ``model``); all-to-all back; gate weighting and combine.  Each source
rank has its own capacity (C from T_loc), and the aux loss averages its
token and gate fractions over the batch axes (``pod`` and ``data``).

The JAX package finds its mesh in a module global
(``set_dispatch_mesh``); here the caller passes the rank's parallel
context (:class:`repro_torch.parallel.ModelParallel`, whose ``place``
answers for the mesh): nothing is global.  The all-to-all is
``torch.distributed.all_to_all_single`` (gloo on the CPU, NCCL on the
card); its backward is the reverse all-to-all.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import (_combine, capacity, expert_ffn, route,
                                    switch_aux)
from repro_torch.parallel import copy_to_model, model_dim, reduce_from_model

__all__ = ["moe_apply_a2a"]


def _a2a(x, group):
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Dim 0 of ``x`` split in ``n`` equal blocks, block j sent to rank j
    of ``group``; block i of the result came from rank i.  The exchange is
    its own transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _all_to_all(x, group):
    """The autograd-aware all-to-all over ``group`` (identity for None)."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


class _MeanOver(torch.autograd.Function):
    """The mean over ``group`` forward; the gradient passes unchanged (each
    rank's share of a global mean)."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _mean_over(x, place):
    group, n, _ = place
    return x if n == 1 else _MeanOver.apply(x, group, n)


def moe_apply_a2a(params, x, mp, *, top_k, act, capacity_factor=1.25,
                  dense_residual=False, axis="data", specs=None):
    """Expert-parallel MoE forward with all-to-all dispatch: x [B_loc, S,
    d] (this rank's batch block) -> (out [B_loc, S, d], aux scalar), the
    semantics of ``moe.moe_apply`` with a capacity per source rank.

    ``params``: this rank's blocks of ``moe.moe_init``'s tree, the experts
    split over ``axis`` on dim 0 (``launch.sharding.param_shardings`` with
    ``ep=True``) and, where ``specs`` (the leaves' specs) split f over
    ``model``, on f too.  ``mp``: the rank's parallel context (None: one
    rank, no exchange)."""
    from repro_torch.parallel import ModelParallel
    mp = mp if mp is not None else ModelParallel()
    group, n_sh, _ = mp.place((axis,))
    mean_place = mp.place(("pod", axis))
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    E = params["router"].shape[1]
    E_loc = params["w1"].shape[0]
    if E != n_sh * E_loc:
        raise ValueError(f"router has {E} experts but {n_sh} shards x "
                         f"{E_loc} local experts")
    tp = (specs is not None and mp.active
          and model_dim(specs["w1"]) == len(specs["w1"]) - 1)

    _, topk_idx, scores, (frac_t, frac_p) = route(xt, params["router"],
                                                  top_k)
    aux = switch_aux(_mean_over(frac_t, mean_place),
                     _mean_over(frac_p, mean_place), top_k)

    cap = capacity(top_k, T, E, capacity_factor)
    w_ec, idx_ec = scores.t().topk(cap, dim=-1)                # [E, C]
    xe = xt[idx_ec.reshape(-1)].reshape(n_sh, E_loc, cap, d)
    recv = _all_to_all(xe, group)                               # [n,E_loc,C,d]
    xw = recv.transpose(0, 1).reshape(E_loc, n_sh * cap, d)
    if tp:
        xw = copy_to_model(xw, mp)
    ye = expert_ffn(xw, params["w1"], params["w2"], params.get("w3"), act)
    if tp:
        ye = reduce_from_model(ye, mp)
    ye = ye.reshape(E_loc, n_sh, cap, d).transpose(0, 1)
    back = _all_to_all(ye, group).reshape(E, cap, d)
    out = _combine(back, w_ec, idx_ec, topk_idx).reshape(B, S, d)
    out = out.to(x.dtype)
    if dense_residual:
        out = out + mlp_apply(params["dense"], x, act, mp=mp if tp else None,
                              specs=specs["dense"] if tp else None)
    return out, aux
