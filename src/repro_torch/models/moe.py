"""Mixture-of-Experts layer with capacity-based gather dispatch (port of
``repro/models/moe.py``).

The router picks each token's top-k experts; each expert then gathers its
top-C assigned tokens ("expert's choice among the assigned"), runs its FFN
as a batched product over [E, C, d] and the gate-weighted results go back
to their tokens.  Tokens past an expert's capacity are dropped; the
Switch-style aux loss discourages that.  The weights are the JAX
package's leaves: ``router`` [d, E], ``w1`` / ``w3`` [E, d, f], ``w2``
[E, f, d] and, with ``dense_residual``, a dense MLP under ``dense``.

Two things differ from the JAX code and not in value:

* JAX scatter-adds the [E, C, d] results into the tokens
  (``out.at[idx].add``), whose order on the card is that of its atomics.
  Here each token gathers its own top-k results (:func:`_combine`) and
  sums them in its top-k order, so a step gives the same bits every time,
  eagerly and in a replayed CUDA graph.  The sums agree with JAX's within
  float32 rounding.
* The capacity pick ``top_k(scores.T, C)`` chooses among many ties at
  zero (tokens not assigned to the expert).  ``torch.topk`` may order
  them otherwise; such slots carry weight 0 and their token does not read
  them, so the outputs agree.

``shard_capacity`` is a GSPMD layout hint in the JAX package (it constrains
the capacity dim to ``model``) and changes no value: it is accepted and
changes nothing here.

Tensor parallelism (``mp``, ``specs`` as :func:`repro_torch.models.layers.
mlp_apply` takes them): the experts' ``w1`` / ``w3`` are column-parallel
on f and ``w2`` row-parallel; the [E, C, d] results are summed over
``model`` before the gate weighting, so the router (replicated) gets its
whole gradient on every rank.  Experts split over ``data`` (the FSDP /
expert-parallel layout) are :mod:`repro_torch.models.moe_dispatch`'s
all-to-all; the gather dispatch refuses them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init
from repro_torch.parallel import (copy_to_model, model_dim,
                                  reduce_from_model, spec_axes)


def moe_init(generator, d_model, n_experts, moe_d_ff, act,
             dtype=torch.float32, dense_residual=False, d_ff=0):
    """The router [d, E], experts [E, d, f] / [E, f, d] (``w3`` with
    ``act="silu"``) and, with ``dense_residual``, a dense MLP of ``d_ff``;
    drawn from ``generator`` with the JAX package's fan-in rule (the first
    dim: E for the experts, as there)."""
    p = {"router": dense_init(generator, (d_model, n_experts), dtype),
         "w1": dense_init(generator, (n_experts, d_model, moe_d_ff), dtype),
         "w2": dense_init(generator, (n_experts, moe_d_ff, d_model), dtype)}
    if act == "silu":
        p["w3"] = dense_init(generator, (n_experts, d_model, moe_d_ff), dtype)
    if dense_residual:
        p["dense"] = mlp_init(generator, d_model, d_ff, act, dtype)
    return p


def route(xt, router, top_k):
    """Softmax gates [T, E] (float32), each token's top-k experts [T, k],
    the gates of the assigned experts (0 elsewhere) [T, E], and the
    per-expert means (fraction of tokens routed, mean gate) that the
    Switch aux loss multiplies."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    topk_idx = gates.topk(top_k, dim=-1).indices
    assign = torch.zeros_like(gates).scatter_(1, topk_idx, 1.0)
    return gates, topk_idx, gates * assign, (assign.mean(0), gates.mean(0))


def switch_aux(frac_tokens, frac_probs, top_k):
    return frac_tokens.shape[0] * torch.sum(frac_tokens * frac_probs) / top_k


def capacity(top_k, T, E, capacity_factor):
    """Each expert's capacity: ``top_k * T / E * capacity_factor`` tokens
    (at least 1, at most T), computed as the JAX package does."""
    return min(int(max(top_k * T / E * capacity_factor, 1)), T)


def expert_ffn(xe, w1, w2, w3, act):
    """[E, C, d] through each expert's FFN: [E, C, d]."""
    h = torch.bmm(xe, w1)
    if act == "silu":
        h = F.silu(h) * torch.bmm(xe, w3)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2)


def _combine(ye, w_ec, idx_ec, topk_idx):
    """out [T, d]: for each token the sum, in its top-k order, of
    ``ye[e, c] * w_ec[e, c]`` over the experts e it was assigned to that
    picked it (at slot c); a token an expert dropped reads 0 there."""
    E, cap, d = ye.shape
    T = topk_idx.shape[0]
    yw = (ye * w_ec[..., None].to(ye.dtype)).reshape(E * cap, d)
    yw = torch.cat([yw, yw.new_zeros((1, d))])
    # slot[e, t]: where expert e holds token t, cap where it does not
    slot = torch.full((E, T), cap, dtype=torch.long, device=ye.device)
    slot.scatter_(1, idx_ec, torch.arange(cap, device=ye.device)
                  .expand(E, cap).contiguous())
    c = slot.t().gather(1, topk_idx)                            # [T, k]
    rows = torch.where(c < cap, topk_idx * cap + c, E * cap)
    return yw[rows.reshape(-1)].reshape(T, -1, d).sum(1)


def _split(mp, specs) -> bool:
    """Whether the experts' f dim is split over ``model``; refuses experts
    split over anything else (``data``: the all-to-all's layout)."""
    if specs is None or mp is None:
        return False
    if mp.place(spec_axes(specs["w1"][0]))[1] > 1:
        raise NotImplementedError(
            "moe_apply: experts split over the expert dim "
            f"({specs['w1']}) run through moe_dispatch.moe_apply_a2a")
    split = mp.active
    w1 = split and model_dim(specs["w1"]) == 2
    if w1 != (split and model_dim(specs["w2"]) == 1):
        raise ValueError(f"moe_apply: w1 {specs['w1']} and w2 "
                         f"{specs['w2']} must split f together")
    return w1


def moe_apply(params, x, *, top_k, act, capacity_factor=1.25,
              dense_residual=False, full_capacity=False,
              shard_capacity=False, mp=None, specs=None):
    """x [B, S, d] -> (out [B, S, d], aux scalar).

    ``full_capacity=True`` sets every expert's capacity to T (no token is
    ever dropped): the decode path, where T = B is tiny and dropping the
    single token of a sequence would corrupt generation.
    ``shard_capacity`` changes nothing (module docstring).  Under ``mp``
    the experts are this rank's f blocks (module docstring)."""
    del shard_capacity
    split = _split(mp, specs)
    B, S, d = x.shape
    E = params["router"].shape[1]
    T = B * S
    xt = x.reshape(T, d)
    gates, topk_idx, scores, fracs = route(xt, params["router"], top_k)
    aux = switch_aux(*fracs, top_k)
    cap = T if full_capacity else capacity(top_k, T, E, capacity_factor)
    w_ec, idx_ec = scores.t().topk(cap, dim=-1)                # [E, C]
    xe = xt[idx_ec.reshape(-1)].reshape(E, cap, d)
    if split:
        xe = copy_to_model(xe, mp)
    ye = expert_ffn(xe, params["w1"], params["w2"], params.get("w3"), act)
    if split:
        ye = reduce_from_model(ye, mp)
    out = _combine(ye, w_ec, idx_ec, topk_idx).reshape(B, S, d).to(x.dtype)
    if dense_residual:
        out = out + mlp_apply(params["dense"], x, act, mp=mp,
                              specs=None if specs is None
                              else specs["dense"])
    return out, aux


def moe_reference(params, x, *, top_k, act, dense_residual=False):
    """Dense-compute oracle: every expert on every token, the exact top-k
    mix, no capacity (the tests' semantic reference)."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    xt = x.reshape(B * S, d)
    _, _, w, _ = route(xt, params["router"], top_k)            # [T, E]
    y = expert_ffn(xt.expand(E, -1, -1), params["w1"], params["w2"],
                   params.get("w3"), act)                      # [E, T, d]
    out = torch.einsum("te,etd->td", w.to(y.dtype), y)
    out = out.reshape(B, S, d).to(x.dtype)
    if dense_residual:
        out = out + mlp_apply(params["dense"], x, act)
    return out
