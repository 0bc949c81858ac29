"""The transformer family (port of ``repro/models/transformer.py``):
global and sliding-window GQA layers in any local:global pattern, RoPE and
Qwen2-VL's M-RoPE, RMS or layer norm, SwiGLU or GELU MLPs, tied or separate
heads, MoE FFNs, SSD and RG-LRU layers, the Whisper encoder with the
decoder's cross-attention, prefill (``forward_seq(..., want_cache=True)``)
and KV-cache decode (``decode_step``).

The parameter and cache trees are the JAX package's, leaf for leaf:
``{"embed", "final_norm", "cycles", "tail"}``, where ``cycles`` is a tuple
with one dict per layer kind of the pattern's repeating cycle, its leaves
stacked over the full cycles (leading axis), and ``tail`` a tuple of the
remaining layers.  The JAX package scans over the cycles; here a Python
loop indexes them.

``cfg.attn_impl == "pallas"`` runs the hand-written kernels: K8a
(``kernels/flash_attn.py``) for the sequence path and K9
(``ops.gqa_flash_decode``) for decode attention.  The JAX package passes
no kernel to ``decode_attention`` and so runs its flash-decode kernel on
no path; the port runs K9 there.  That is a deliberate difference:
the same function, decode attention over the cache up to its valid
length.  ``attn_impl == "jnp"`` runs plain attention in torch ops (K9's
plain version, the masked softmax ``decode_attention`` computes).  The
second deliberate difference is the Whisper encoder's bidirectional
self-attention: under ``"pallas"`` the JAX package runs its blocked jnp
softmax there (``attn.flash_attention(..., causal=False)``), the port the
same function with K8a's own ``causal=False`` mode (and K8b / K8c in the
backward) through ``make_flash_attention(causal=False)``, the mode the
Pallas kernel has and no JAX path calls.

``decode_step`` updates the cache **in place** (the new key and value are
written into their slot; the returned cache is the same tensors), where the
JAX package returns a new cache from ``dynamic_update_slice``.

``forward_seq`` trains: gradients reach the stacked ``cycles`` leaves
through the per-cycle indexing, and under ``attn_impl == "pallas"`` the
attention backward is K8b / K8c (``kernels/flash_attn.py``).

Tensor parallelism (``tp=``, a :class:`repro_torch.parallel.TensorParallel`
whose ``model`` axis has more than one rank): the parameters are this
rank's blocks under ``launch.sharding.param_shardings`` and every layer
follows its leaves' specs (``models.layers.mlp_apply``,
``models.attention.project_qkv`` / ``project_out``).  The token table
[V, d] is split on V: the lookup shifts the ids into the rank's range,
zeroes the rows it does not own and sums over ``model``; the head's
logits come out split on V (``core.losses.cross_entropy`` takes them so;
serving gathers them).  The cache is the rank's block under
``launch.sharding.cache_shardings``: its length L split over ``model``
(and over the batch axes at batch 1).  A decode step gathers q, k and v
to all heads, writes the new k and v into the slice that owns the slot
without a branch (every rank runs the same ops, and the one that does
not own the slot writes back what it holds), runs K9 on its slice up to
``clamp(valid - offset, 0, L_loc)`` with each row's log-sum-exp, and
merges the slices' ``(o, lse)`` pairs (``kernels.decode_attn.
merge_partials``) after one all-gather.  Nothing in a step syncs with the
host or branches on the device's ``pos``, so a step can be captured.

MoE FFNs (``cfg.n_experts``: ``models/moe.py``) take the place of an
attention layer's MLP, as in the JAX package: ``forward_seq`` returns the
sum of the layers' Switch aux losses under ``"aux"``, prefill and training
drop tokens past an expert's capacity (``cfg.moe_capacity``), and decode
runs every expert at full capacity.  ``cfg.moe_dispatch == "a2a"`` sends
the tokens to experts split over ``data`` with an all-to-all
(``models/moe_dispatch.py``) through ``tp``'s parallel context, which it
needs.  Under ``tp`` the experts follow their specs: f split over
``model`` (``w1`` / ``w3`` column-parallel, ``w2`` row-parallel), the
router replicated.

The recurrent block kinds (the JAX package's): Mamba-2 SSD layers
(``models/ssd.py``: the SSD mixer, no norm after it, no FFN) and RG-LRU
layers (``models/rglru.py``: the recurrent mixer, then the MLP), alone
(mamba2-130m) or in a pattern with local attention (recurrentgemma-9b).
Their caches are ``{"h", "conv"}``: the recurrent state (float32) and the
last ``conv_width - 1`` conv inputs.  Prefill computes them from the
sequence (SSD's state in the JAX package's closed form); ``decode_step``
computes the new state and the shifted window into fresh tensors and
copies them into the cache leaves, so the step stays in place as for the
K/V caches.  A prompt shorter than ``conv_width - 1`` raises
``ValueError`` (the JAX package would make a short conv cache that its own
decode then fails on).  Under ``tp`` they run on the rank's blocks of
the JAX layout (``models/rglru.py``: W split, the conv output gathered
before the gates; ``models/ssd.py``: the P slice of every head, ``y``
gathered; each module's docstring), their caches the rank's blocks of
``h`` and ``conv`` (the layer's own cache specs).

``cfg.remat`` (activation checkpointing) follows the JAX package:
``"layer"`` wraps each full cycle of ``forward_seq`` (every layer of one
cycle; not the tail, not with ``want_cache``) in
``torch.utils.checkpoint.checkpoint``, so the backward recomputes the
cycle from its input instead of keeping its activations (under
``attn_impl="pallas"`` K8a then runs twice a cycle's attention layer in a
step, and under ``tp`` the cycle's forward collectives run again in the
backward); ``"attn"`` checkpoints the plain attention only
(``attn_impl="jnp"``; K8a's autograd function already keeps only q, k, v,
o and lse, and the JAX package's branch order ignores ``remat`` there).
Both use ``use_reentrant=False`` and ``preserve_rng_state=False``: the
forward draws no random numbers, and saving the CUDA generator's state
would read it inside the LM engine's CUDA-graph capture.  Nothing is
checkpointed where autograd is off (eval, serving).

The encoder-decoder (whisper-large-v3, ``cfg.n_enc_layers``): the batch
carries stub frame embeddings ``audio_frames`` [B, F, d]; the encoder
(``params["enc"]``: ``in_proj``, sinusoidal positions, ``n_enc_layers``
bidirectional layers stacked on a leading axis, a final layer norm) runs
once a forward, and every decoder layer adds cross-attention (``lnx``,
``xattn``) after its self-attention.  Sequence mode computes it with the
plain masked softmax on both devices, q [B,S,H,hd] against the encoder's
k / v [B,F,KV,hd], as the JAX package does outside any Pallas kernel (its
``flash_fwd`` is self-attention only, S == Sk); ``remat="layer"``
checkpoints the decoder's cycles, never the encoder, which the JAX package
scans without ``jax.checkpoint``.  The cache of a decoder layer adds the
cross keys and values ``xk`` / ``xv`` [B,F,KV,hd], written by prefill and
read, never written, by ``decode_step`` (K9 under ``"pallas"`` with no
valid length: all F frames).  Audio layers use layer norm with bias and
the GELU MLP, and the tokens sinusoidal absolute positions (the decode
step's from ``layers.sinusoidal_position_at`` on the device's ``pos``).

The VLM (qwen2-vl-7b, ``cfg.family == "vlm"``): the batch may carry stub
patch embeddings ``vision_embeds`` [B, n_vision_tokens, d], projected by
``params["vis_proj"]`` and put in place of the first ``n_vision_tokens``
token embeddings (a shorter prompt raises ``ValueError``), and M-RoPE
positions ``mrope_positions`` [3, B, S] (temporal, height, width); without
them every stream is the token's position, as at decode.

Under ``tp`` the two families split as the dense stack does: the
encoder's layers and the decoder's cross-attention run head-parallel (or
gathered) with the MLP's column / row split; ``vis_proj`` and the
encoder's ``in_proj`` (the JAX layouts' generic ``w``, split on its
columns) have their blocks gathered before the residual stream; the cross
cache ``xk`` / ``xv`` is the rank's block under ``cache_shardings`` (its
F frames split over ``model``, say 1,500 as 750 + 750), and a decode step
runs K9 on the rank's F slice with no valid length and each row's
log-sum-exp, then merges the slices after one all-gather, as for the
self cache.

FSDP (``tp.fsdp``, the ``client_sequential`` round on a mesh with
``data`` > 1; ``repro_torch.parallel``): every leaf split over ``data`` is
gathered just before use, a layer's inside its ``remat="layer"`` cycle
(so the backward gathers it again and only the blocks are kept); each
data rank runs its share of the client's rows, except an MoE layer, whose
gather dispatch routes the whole batch (:func:`_ffn`).  The token table
and the head, the largest leaves, are not gathered where the rows are
split: the lookup and the head move the rows' columns and the partial
logits instead (:func:`_embed_tokens`, :func:`head_apply`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD,
                                      ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import flash_decode_plain, merge_partials
from repro_torch.kernels.flash_attn import make_flash_attention
from repro_torch.parallel import (columns_of_rows, copy_to_model, data_dim,
                                  fsdp_gather, gather_from_data,
                                  gather_replicated, model_dim,
                                  reduce_from_model, rows_to_columns,
                                  spec_axes, sum_onto_rows)
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       sinusoidal_position_at,
                                       sinusoidal_positions)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.moe_dispatch import moe_apply_a2a
from repro_torch.models.rope import apply_mrope, apply_rope
from repro_torch.tree import tree_map, tree_with_path

_ATTN = (ATTN_GLOBAL, ATTN_LOCAL)
_RECURRENT = (SSD, RGLRU)


def _check_supported(cfg: ArchConfig, tp=None) -> None:
    bad = sorted(set(cfg.block_pattern) - set(_ATTN) - set(_RECURRENT))
    if bad:
        raise ValueError(f"{cfg.name}: unknown block kinds {bad}")


# ---------------------------------------------------------------------------
# Pattern -> cycles
# ---------------------------------------------------------------------------

def pattern_cycle(pattern):
    """Minimal c with pattern[i] == pattern[i % c] for all i."""
    n = len(pattern)
    for c in range(1, n + 1):
        if all(pattern[i] == pattern[i % c] for i in range(n)):
            return c
    return n


def cycle_split(pattern):
    c = pattern_cycle(pattern)
    n_full = len(pattern) // c
    rem = len(pattern) - n_full * c
    return c, n_full, rem


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def _norm_kind(cfg: ArchConfig) -> str:
    return "layernorm" if cfg.family == "audio" else "rmsnorm"


def _layer_init(generator, cfg: ArchConfig, kind: str, dtype, cross=False):
    """One layer's parameters; ``kind`` a block kind or ``"enc"`` (an
    encoder layer); ``cross`` adds a decoder layer's cross-attention."""
    nk = _norm_kind(cfg)
    dev = generator.device
    p = {"ln1": norm_init(nk, cfg.d_model, dtype, dev)}
    if kind == SSD:
        p["ssd"] = ssd_mod.ssd_init(generator, cfg.d_model,
                                    expand=cfg.ssm_expand,
                                    d_state=cfg.ssm_state,
                                    head_dim=cfg.ssm_head_dim,
                                    conv_width=cfg.ssm_conv_width,
                                    dtype=dtype)
        return p
    if kind == RGLRU:
        p["rglru"] = rglru_mod.rglru_init(generator, cfg.d_model,
                                          cfg.lru_width, dtype=dtype)
    else:
        p["attn"] = attn.attn_init(generator, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, dtype)
        if cross:
            p["lnx"] = norm_init(nk, cfg.d_model, dtype, dev)
            p["xattn"] = attn.attn_init(generator, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, dtype)
    p["ln2"] = norm_init(nk, cfg.d_model, dtype, dev)
    if cfg.n_experts and kind in _ATTN:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.n_experts,
                            cfg.moe_d_ff, cfg.act, dtype,
                            dense_residual=cfg.dense_residual, d_ff=cfg.d_ff)
    else:
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _ssd_kw(cfg: ArchConfig):
    return dict(expand=cfg.ssm_expand, d_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, conv_width=cfg.ssm_conv_width)


def _apply_rope_any(cfg: ArchConfig, q, k, positions, mrope_pos=None):
    if cfg.family == "audio" or cfg.rope_theta <= 0:
        return q, k     # whisper uses absolute sinusoidal positions
    if cfg.mrope and mrope_pos is not None:
        return apply_mrope(q, k, mrope_pos, theta=cfg.rope_theta,
                           head_dim=cfg.head_dim,
                           sections=cfg.mrope_sections)
    return apply_rope(q, k, positions, theta=cfg.rope_theta,
                      head_dim=cfg.head_dim,
                      partial_pct=cfg.partial_rotary_pct)


def _mp(tp):
    """The model-axis context of ``tp`` when it splits anything, else None."""
    return tp.mp if tp is not None and tp.active else None


def _ffn(cfg: ArchConfig, p, hn, *, tp, ps, decode=False):
    """The layer's FFN on ``hn``: (out, aux), aux None for a dense MLP.
    MoE decode runs every expert at full capacity (T = B tokens, none
    dropped), as the JAX package does.  Under FSDP with the rows split
    over ``data`` the gather dispatch routes the client's whole batch:
    its tokens are gathered over ``data`` (an expert's capacity and the
    aux loss are the whole batch's, as on one device), and the rank keeps
    its rows of the output."""
    if not cfg.n_experts:
        return mlp_apply(p["ffn"], hn, cfg.act, mp=_mp(tp),
                         specs=None if ps is None else ps["ffn"]), None
    mp = None if tp is None else tp.mp
    kw = dict(top_k=cfg.top_k, act=cfg.act,
              dense_residual=cfg.dense_residual,
              specs=None if ps is None else ps["moe"])
    if decode:
        return moe_apply(p["moe"], hn, full_capacity=True, mp=mp, **kw)
    if cfg.moe_dispatch == "a2a":
        if tp is None:
            raise ValueError(f"{cfg.name}: moe_dispatch='a2a' needs the "
                             "rank's parallel context (tp=, from "
                             "launch.steps on a mesh)")
        return moe_apply_a2a(p["moe"], hn, tp.mp,
                             capacity_factor=cfg.moe_capacity, **kw)
    rows = tp is not None and tp.data_rows
    if rows:
        hn = gather_from_data(hn, 0, mp)
    out, aux = moe_apply(p["moe"], hn, capacity_factor=cfg.moe_capacity,
                         shard_capacity=cfg.moe_shard_capacity, mp=mp, **kw)
    if rows:
        out = out.chunk(tp.data_size, 0)[mp.place(("data",))[2]]
    return out, aux


def _fsdp_layer(cfg: ArchConfig, p, ps, tp):
    """A layer's parameters with their FSDP blocks gathered over ``data``
    (and their specs without ``data``); the experts stay split where the
    all-to-all dispatch reaches them there."""
    a2a = cfg.moe_dispatch == "a2a"
    return fsdp_gather(p, ps, tp, keep=lambda s: a2a and len(s) == 3
                       and data_dim(s) == 0)


def _l_parts(tp, spec):
    """(group, count, position) of the ranks a cache's length (dim 1 of
    ``spec``) is split over: one rank without ``tp``."""
    if tp is None or spec is None:
        return None, 1, 0
    return tp.mp.place(spec_axes(spec[1]))


def _cross_attention(cfg: ArchConfig, p, h, enc_out, *, mp=None, ps=None):
    """The decoder layer's cross-attention branch in sequence mode:
    (residual to add, its k, v [B,F,KV',hd]).  Bidirectional q [B,S,H',hd]
    against the encoder's F frames, the plain masked softmax on every
    device (the JAX package's jnp ``flash_attention(..., causal=False)``;
    the queries' k / v projections it also computes are unused).  Split
    over ``model`` the heads are split as the self-attention's
    (``attn.project_qkv``: this rank's heads, KV' = KV / m, where they
    divide; gathered otherwise)."""
    hx = norm_apply(_norm_kind(cfg), p["lnx"], h, cfg.norm_eps)
    px = p["xattn"]
    kw = dict(mp=mp, specs=None if ps is None else ps["xattn"])
    q, = attn.project_qkv(px, hx, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          names=("wq",), **kw)
    k, v = attn.project_qkv(px, enc_out, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, names=("wk", "wv"), **kw)
    o = attn.flash_attention(q, k, v, causal=False)
    return attn.project_out(px, o, **kw), k, v


def _all_heads(cfg, mp, k, v):
    """k, v with all KV heads (a head-parallel rank gathers them; no
    autograd: the cache is not trained)."""
    if mp is not None and k.shape[2] != cfg.n_kv_heads:
        with torch.no_grad():
            return mp.all_gather(k, 2), mp.all_gather(v, 2)
    return k, v


def _layer_seq(cfg: ArchConfig, kind: str, p, h, *, positions, want_cache,
               max_len, tp=None, ps=None, cache_spec=None, mrope_pos=None,
               enc_out=None):
    """Sequence-mode layer. Returns (h, aux or None, cache_or_None).
    ``ps``: the layer's parameter specs, ``cache_spec`` its cache's specs
    (under ``tp``); ``mrope_pos`` [3,B,S] M-RoPE positions; ``enc_out``
    the encoder's output [B,F,d] (a decoder layer with cross-attention)."""
    if kind in _RECURRENT:
        return _recurrent_seq(cfg, kind, p, h, want_cache, tp=tp, ps=ps)
    nk = _norm_kind(cfg)
    mp = _mp(tp)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], hn, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, mp=mp,
                               specs=None if ps is None else ps["attn"])
    q, k = _apply_rope_any(cfg, q, k, positions, mrope_pos)
    window = cfg.sliding_window if kind == ATTN_LOCAL else None
    if cfg.attn_impl == "pallas":
        o = make_flash_attention(causal=True, window=window)(q, k, v)
    elif cfg.remat == "attn" and torch.is_grad_enabled():
        # keep only (q, k, v); the backward recomputes the softmax
        o = _checkpoint(functools.partial(attn.flash_attention,
                                          window=window), q, k, v)
    else:
        o = attn.flash_attention(q, k, v, window=window)
    h = h + attn.project_out(p["attn"], o, mp=mp,
                             specs=None if ps is None else ps["attn"])
    cache = None
    if want_cache:
        # head-parallel: the cache holds all heads
        cache = _seq_kv_to_cache(cfg, kind, *_all_heads(cfg, mp, k, v),
                                 max_len)
        if tp is not None and cache_spec is not None:
            cache = {n: _l_block(t, cache_spec["k"], tp)
                     for n, t in cache.items()}
    if "xattn" in p:
        out, xk, xv = _cross_attention(cfg, p, h, enc_out, mp=mp, ps=ps)
        h = h + out
        if want_cache:
            xk, xv = _all_heads(cfg, mp, xk, xv)
            if tp is not None and cache_spec is not None:
                xk = _l_block(xk, cache_spec["xk"], tp)
                xv = _l_block(xv, cache_spec["xv"], tp)
            cache["xk"], cache["xv"] = xk, xv
    ff, aux = _ffn(cfg, p, norm_apply(nk, p["ln2"], h, cfg.norm_eps),
                   tp=tp, ps=ps)
    return h + ff, aux, cache


def _checkpoint(fn, *args):
    """``fn(*args)`` under activation checkpointing (module docstring: no
    RNG state is kept, the forward draws none)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _recurrent_seq(cfg: ArchConfig, kind: str, p, h, want_cache, *,
                   tp=None, ps=None):
    """Sequence-mode SSD or RG-LRU layer: (h, None, cache_or_None); under
    ``tp`` on the rank's blocks (``models/ssd.py``, ``models/rglru.py``),
    the cache the rank's blocks of ``h`` and ``conv``."""
    nk = _norm_kind(cfg)
    mp = _mp(tp)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    if kind == SSD:
        out = ssd_mod.ssd_apply(p["ssd"], hn, chunk=cfg.ssm_chunk,
                                want_cache=want_cache, mp=mp,
                                specs=None if ps is None else ps["ssd"],
                                **_ssd_kw(cfg))
    else:
        out = rglru_mod.rglru_apply(p["rglru"], hn, want_cache=want_cache,
                                    mp=mp, specs=None if ps is None
                                    else ps["rglru"])
    y, cache = out if want_cache else (out, None)
    h = h + y
    if kind == RGLRU:
        h = h + mlp_apply(p["ffn"], norm_apply(nk, p["ln2"], h,
                                               cfg.norm_eps), cfg.act,
                          mp=mp, specs=None if ps is None else ps["ffn"])
    return h, None, cache


def _recurrent_decode(cfg: ArchConfig, kind: str, p, h, cache, *, tp=None,
                      ps=None):
    """Decode-mode SSD or RG-LRU layer: h [B,1,d].  The new state and the
    shifted conv window are fresh tensors, copied into ``cache`` (its
    leaves keep their storage: a captured step reads and writes them);
    under ``tp`` the rank's blocks."""
    nk = _norm_kind(cfg)
    mp = _mp(tp)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    if kind == SSD:
        y, new = ssd_mod.ssd_decode(p["ssd"], hn, cache, mp=mp,
                                    specs=None if ps is None else ps["ssd"],
                                    **_ssd_kw(cfg))
    else:
        y, new = rglru_mod.rglru_decode(p["rglru"], hn, cache, mp=mp,
                                        specs=None if ps is None
                                        else ps["rglru"])
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    h = h + y
    if kind == RGLRU:
        h = h + mlp_apply(p["ffn"], norm_apply(nk, p["ln2"], h,
                                               cfg.norm_eps), cfg.act,
                          mp=mp, specs=None if ps is None else ps["ffn"])
    return h, cache


def _l_block(t, spec, tp):
    """This rank's slice of a [B, L, KV, hd] cache tensor along L under
    the k spec ``spec`` (the batch arrives already split)."""
    _, n, position = tp.mp.place(spec_axes(spec[1]))
    if n == 1:
        return t
    L_loc = t.shape[1] // n
    return t[:, position * L_loc:(position + 1) * L_loc].clone(
        memory_format=torch.contiguous_format)


def _pad_seq(x, L):
    """x [B,S,...] zero-padded to [B,L,...] along the sequence."""
    out = x.new_zeros((x.shape[0], L) + tuple(x.shape[2:]))
    out[:, :x.shape[1]] = x
    return out


def _seq_kv_to_cache(cfg, kind, k, v, max_len):
    """Stores the sequence's K/V into a fixed-size cache buffer."""
    S = k.shape[1]
    if kind == ATTN_GLOBAL:
        return {"k": _pad_seq(k, max_len), "v": _pad_seq(v, max_len)}
    # local: keep the last `window` positions, ring-aligned so that
    # buffer[t % L] holds the K/V of position t
    L = min(cfg.sliding_window, max_len)
    if S <= L:
        return {"k": _pad_seq(k, L), "v": _pad_seq(v, L)}
    shift = S % L
    return {"k": torch.roll(k[:, S - L:], shift, dims=1),
            "v": torch.roll(v[:, S - L:], shift, dims=1)}


def _merge_slices(tp, o, lse, group, n):
    """The attention over a cache split over ``n`` ranks from this rank's
    ``(o, lse)`` on its slice: one all-gather, then
    ``decode_attn.merge_partials``."""
    B, _, H, hd = o.shape
    both = tp.mp.all_gather(torch.cat([o.reshape(B, H * hd), lse],
                                      dim=1)[None], 0, group=group, size=n)
    return merge_partials(both[:, :, :H * hd].reshape(n, B, 1, H, hd),
                          both[:, :, H * hd:])


def _layer_decode(cfg: ArchConfig, kind: str, p, h, cache, *, pos,
                  positions, tp=None, ps=None, cache_spec=None,
                  mrope_pos=None):
    """Decode-mode layer: h [B,1,d], pos a 0-d int64 tensor on
    h's device.  Writes the new K/V into ``cache`` in place; returns
    (h, cache).  Under ``tp`` the layer runs on this rank's blocks and its
    slice of the cache (module docstring): no host sync, no branch on
    ``pos``; only whether the cache is split (a Python fact) picks the
    sliced write and the merge.  An SSD or RG-LRU layer updates its state
    and conv window in place (:func:`_recurrent_decode`).  A decoder layer
    with cross-attention then attends over its cross cache ``xk`` /
    ``xv`` (K9 under ``"pallas"``, no valid length), which it never
    writes; split over ranks (on F), K9 runs on the rank's slice with each
    row's log-sum-exp and the slices are merged as the self cache's."""
    if kind in _RECURRENT:
        return _recurrent_decode(cfg, kind, p, h, cache, tp=tp, ps=ps)
    nk = _norm_kind(cfg)
    mp = _mp(tp)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], hn, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, mp=mp,
                               specs=None if ps is None else ps["attn"],
                               gather=True)
    q, k = _apply_rope_any(cfg, q, k, positions, mrope_pos)
    group, n, position = _l_parts(tp, None if cache_spec is None
                                  else cache_spec["k"])
    L_loc = cache["k"].shape[1]
    L = L_loc * n
    slot = pos % L if kind == ATTN_LOCAL else pos
    valid = torch.clamp(pos + 1, max=L)
    if n == 1:
        cache["k"].index_copy_(1, slot.reshape(1), k)
        cache["v"].index_copy_(1, slot.reshape(1), v)
    else:     # every rank writes; one that does not own the slot rewrites
        offset = position * L_loc
        local = slot - offset
        own = (local >= 0) & (local < L_loc)
        idx = local.clamp(0, L_loc - 1).reshape(1)
        for name, new in (("k", k), ("v", v)):
            old = cache[name].index_select(1, idx)
            cache[name].index_copy_(1, idx, torch.where(own, new, old))
        valid = (valid - offset).clamp(0, L_loc)
    decode = (ops.gqa_flash_decode if cfg.attn_impl == "pallas"
              else flash_decode_plain)
    o = decode(q, cache["k"], cache["v"], valid, want_lse=n > 1)
    if n > 1:
        o = _merge_slices(tp, *o, group, n)
    h = h + attn.project_out(p["attn"], o, mp=mp,
                             specs=None if ps is None else ps["attn"])
    if "xattn" in p:
        hx = norm_apply(nk, p["lnx"], h, cfg.norm_eps)
        kw = dict(mp=mp, specs=None if ps is None else ps["xattn"])
        qx, = attn.project_qkv(p["xattn"], hx, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, gather=True, names=("wq",),
                               **kw)
        group, n, _ = _l_parts(tp, None if cache_spec is None
                               else cache_spec["xk"])
        o = decode(qx, cache["xk"], cache["xv"], want_lse=n > 1)
        if n > 1:
            o = _merge_slices(tp, *o, group, n)
        h = h + attn.project_out(p["xattn"], o, **kw)
    ff, _ = _ffn(cfg, p, norm_apply(nk, p["ln2"], h, cfg.norm_eps), tp=tp,
                 ps=ps, decode=True)
    return h + ff, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (on its own device: a CUDA
    generator draws on the card), placed on ``device`` (None: the card)."""
    _check_supported(cfg)
    device = resolve_device(device)
    c, n_full, rem = cycle_split(cfg.block_pattern)
    cross = cfg.n_enc_layers > 0
    cycles = []
    for j in range(c):
        cycles.append(_stack([_layer_init(generator, cfg,
                                          cfg.block_pattern[j], dtype, cross)
                              for _ in range(n_full)]))
    tail = tuple(_layer_init(generator, cfg,
                             cfg.block_pattern[n_full * c + j], dtype, cross)
                 for j in range(rem))
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": norm_init(_norm_kind(cfg), cfg.d_model, dtype,
                                generator.device),
        "cycles": tuple(cycles),
        "tail": tail,
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(generator,
                                          (cfg.d_model, cfg.vocab_size),
                                          dtype)}
    if cfg.family == "vlm":
        params["vis_proj"] = {"w": dense_init(generator,
                                              (cfg.d_model, cfg.d_model),
                                              dtype)}
    if cfg.n_enc_layers:
        params["enc"] = {
            "layers": _stack([_layer_init(generator, cfg, "enc", dtype)
                              for _ in range(cfg.n_enc_layers)]),
            "norm": norm_init(_norm_kind(cfg), cfg.d_model, dtype,
                              generator.device),
            "in_proj": {"w": dense_init(generator,
                                        (cfg.d_model, cfg.d_model), dtype)},
        }
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Forward: sequence mode (prefill)
# ---------------------------------------------------------------------------

def _leaf(tp, x, spec):
    """Leaf ``x`` with its FSDP block gathered over ``data`` (under an FSDP
    ``tp``; as it is otherwise)."""
    if tp is None or tp.data_size == 1 or data_dim(spec) is None:
        return x
    return gather_from_data(x, data_dim(spec), tp.mp)


def _embed_tokens(params, tokens, tp):
    """The token lookup; vocab-parallel when ``tp`` splits the table on V:
    each rank looks up the ids in its range, zeroes the others' rows and
    the sum over ``model`` completes every row.  Under FSDP the table's
    block split on d over ``data`` is not gathered: each rank looks up its
    columns of the client's rows (gathered: the ids are small) and one
    all-to-all hands each rank its own rows' whole width
    (``parallel.rows_to_columns``), so the step moves the rows, not the
    table; its gradient is then the whole gradient of the rank's columns.
    Where every data rank holds the same rows, the columns are gathered
    (``gather_from_data``)."""
    table = params["embed"]["table"]
    spec = None if tp is None else tp.model_specs["embed"]["table"]
    if tp is None or tp.data_size == 1 or data_dim(spec) != 1:
        if tp is not None:
            table = _leaf(tp, table, spec)
        return _lookup(table, tokens, tp, spec)
    mp = tp.mp
    if not tp.data_rows:
        return gather_from_data(_lookup(table, tokens, tp, spec), -1, mp)
    group, n, _ = mp.place(("data",))
    ids = mp.all_gather(tokens, 0, group=group, size=n)
    return rows_to_columns(_lookup(table, ids, tp, spec), mp)


def _lookup(table, tokens, tp, spec):
    """Rows of ``table`` (whole, or this rank's V block under ``tp``)."""
    # F.embedding, not ``table[tokens]``: the indexing backward on the CPU
    # (index_put_ with accumulate) adds the rows of repeated tokens in a
    # thread-dependent order, so two equal calls could differ by an ulp;
    # embedding's backward (index_add_) adds them in index order
    mp = _mp(tp)
    if mp is None or model_dim(spec) != 0:
        return F.embedding(tokens, table)
    V_loc = table.shape[0]
    local = tokens - mp.rank * V_loc
    own = (local >= 0) & (local < V_loc)
    rows = F.embedding(local.clamp(0, V_loc - 1), table)
    return reduce_from_model(rows * own.unsqueeze(-1).to(rows.dtype), mp)


def _column_proj(tp, x, p, spec):
    """``x @ p["w"]`` for a generic projection ``w`` [d, d] whose output
    enters the residual stream: split on its columns over ``model``, the
    blocks are gathered (:func:`repro_torch.parallel.gather_replicated`:
    every rank holds the stream's gradient whole)."""
    mp = _mp(tp)
    if mp is None or model_dim(spec["w"]) != 1:
        return x @ _leaf(tp, p["w"], None if tp is None else spec["w"])
    return gather_replicated(x @ _leaf(tp, p["w"], spec["w"]), -1, mp)


def _embed_inputs(cfg, params, batch, tp=None):
    """The token embeddings, the projected vision embeddings in place of
    the first ``n_vision_tokens`` (VLM), plus sinusoidal positions
    (audio)."""
    h = _embed_tokens(params, batch["tokens"], tp)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        ve = _column_proj(tp, batch["vision_embeds"], params["vis_proj"],
                          None if tp is None
                          else tp.model_specs["vis_proj"])
        nv = ve.shape[1]
        if h.shape[1] < nv:
            # the JAX concat would return nv positions, not S
            raise ValueError(f"{cfg.name}: a prompt of {h.shape[1]} tokens "
                             f"is shorter than its {nv} vision tokens")
        h = torch.cat([ve.to(h.dtype), h[:, nv:]], dim=1)
    if cfg.family == "audio":
        h = h + sinusoidal_positions(h.shape[1], cfg.d_model, h.dtype,
                                     h.device)[None]
    return h


def _run_encoder(cfg: ArchConfig, params, frames, tp=None):
    """The Whisper encoder over stub frame embeddings [B,F,d]: bidirectional
    self-attention (K8a / K8b / K8c with ``causal=False`` under
    ``"pallas"``, the plain masked softmax otherwise) and the GELU MLP per
    layer, then the final layer norm.  Under ``tp`` each layer runs on the
    rank's blocks as a decoder layer does (head-parallel attention where
    the heads divide, the MLP's column / row split), and ``in_proj``'s
    column blocks are gathered before the residual stream."""
    nk = _norm_kind(cfg)
    enc = params["enc"]
    es = None if tp is None else tp.model_specs["enc"]
    mp = _mp(tp)
    h = _column_proj(tp, frames, enc["in_proj"],
                     None if es is None else es["in_proj"])
    h = h + sinusoidal_positions(frames.shape[1], cfg.d_model, h.dtype,
                                 h.device)[None]
    for i in range(cfg.n_enc_layers):
        p = tree_map(lambda x: x[i], enc["layers"])
        ps = None if es is None else _drop_lead(es["layers"])
        p, ps = _fsdp_layer(cfg, p, ps, tp)
        hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
        kw = dict(mp=mp, specs=None if ps is None else ps["attn"])
        q, k, v = attn.project_qkv(p["attn"], hn, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, **kw)
        if cfg.attn_impl == "pallas":
            o = make_flash_attention(causal=False)(q, k, v)
        else:
            o = attn.flash_attention(q, k, v, causal=False)
        h = h + attn.project_out(p["attn"], o, **kw)
        h = h + mlp_apply(p["ffn"], norm_apply(nk, p["ln2"], h,
                                               cfg.norm_eps), cfg.act,
                          mp=mp, specs=None if ps is None else ps["ffn"])
    return norm_apply(nk, enc["norm"], h, cfg.norm_eps)


def _layer_parts(tp, cycle, j):
    """The parameter and cache specs of a layer of cycle kind ``j``
    (``cycle``), or of tail layer ``j``: (None, None) without ``tp``.  The
    cache specs are the layer's own (``k`` / ``v``, the cross cache's
    ``xk`` / ``xv``, a recurrent layer's ``h`` / ``conv``)."""
    if tp is None:
        return None, None
    group = "cycles" if cycle else "tail"
    ps = tp.model_specs[group][j]
    cs = None if tp.cache_specs is None else tp.cache_specs[group][j]
    if cycle:     # drop the stacked (cycle) dim
        ps = _drop_lead(ps)
        cs = None if cs is None else _drop_lead(cs)
    return ps, cs


def _drop_lead(specs):
    if isinstance(specs, dict):
        return {k: _drop_lead(v) for k, v in specs.items()}
    return specs[1:]


def forward_seq(cfg: ArchConfig, params, batch, *, want_cache=False,
                want_logits=True, max_cache_len: Optional[int] = None,
                tp=None):
    """batch: {'tokens': [B,S] int, 'vision_embeds'? [B,nv,d],
    'audio_frames'? [B,F,d], 'mrope_positions'? [3,B,S]} -> {'logits'?,
    'features', 'aux' (the layers' MoE aux losses summed; 0 for a dense
    stack), 'cache'?}; runs on the parameters' device.  Under ``tp`` the
    logits are this rank's V block and the cache its block under
    ``tp.cache_specs`` (module docstring)."""
    _check_supported(cfg, tp)
    h = _embed_inputs(cfg, params, batch, tp)
    B, S = h.shape[:2]
    max_len = max_cache_len or S
    positions = torch.arange(S, device=h.device)
    mrope_pos = batch.get("mrope_positions")
    if cfg.mrope and mrope_pos is None:
        mrope_pos = positions.expand(3, B, S)
    enc_out = None
    if cfg.n_enc_layers:
        if "audio_frames" not in batch:
            raise ValueError(f"{cfg.name}: the batch needs 'audio_frames' "
                             "[B, F, d_model], the encoder's input")
        enc_out = _run_encoder(cfg, params, batch["audio_frames"], tp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    c, n_full, rem = cycle_split(cfg.block_pattern)
    caches = [[] for _ in range(c)]

    def cycle(i, h, aux):
        """Cycle ``i``'s layers: (h, aux, one cache per layer)."""
        cycle_caches = []
        for j, kind in enumerate(cfg.block_pattern[:c]):
            p = tree_map(lambda x: x[i], params["cycles"][j])
            ps, cs = _layer_parts(tp, True, j)
            p, ps = _fsdp_layer(cfg, p, ps, tp)
            h, a, cache = _layer_seq(cfg, kind, p, h, positions=positions,
                                     want_cache=want_cache, max_len=max_len,
                                     tp=tp, ps=ps, cache_spec=cs,
                                     mrope_pos=mrope_pos, enc_out=enc_out)
            aux = aux if a is None else aux + a
            cycle_caches.append(cache)
        return h, aux, cycle_caches

    remat = (cfg.remat == "layer" and not want_cache
             and torch.is_grad_enabled())
    for i in range(n_full):
        if remat:
            # the backward recomputes the cycle from (h, aux) instead of
            # keeping its activations (JAX: jax.checkpoint(cycle_body))
            h, aux = _checkpoint(lambda h_, a_, i=i: cycle(i, h_, a_)[:2],
                                 h, aux)
            continue
        h, aux, cycle_caches = cycle(i, h, aux)
        for j, cache in enumerate(cycle_caches):
            caches[j].append(cache)
    tail_caches = []
    for j in range(rem):
        kind = cfg.block_pattern[n_full * c + j]
        ps, cs = _layer_parts(tp, False, j)
        p, ps = _fsdp_layer(cfg, params["tail"][j], ps, tp)
        h, a, cache = _layer_seq(cfg, kind, p, h,
                                 positions=positions, want_cache=want_cache,
                                 max_len=max_len, tp=tp, ps=ps,
                                 cache_spec=cs, mrope_pos=mrope_pos,
                                 enc_out=enc_out)
        aux = aux if a is None else aux + a
        tail_caches.append(cache)

    feats = norm_apply(_norm_kind(cfg), params["final_norm"], h, cfg.norm_eps)
    out = {"features": feats, "aux": aux}
    if want_logits:
        out["logits"] = head_apply(cfg, params, head_input(cfg, feats, tp),
                                   tp)
    if want_cache:
        out["cache"] = {"cycles": tuple(_stack(cs) for cs in caches),
                        "tail": tuple(tail_caches)}
    return out


def head_split(cfg, tp) -> bool:
    if _mp(tp) is None:
        return False
    if cfg.tie_embeddings:
        return model_dim(tp.model_specs["embed"]["table"]) == 0
    return model_dim(tp.model_specs["head"]["w"]) == 1


def head_input(cfg: ArchConfig, feats, tp=None):
    """``feats`` as the head's input: copied to ``model`` where the head is
    split on V (its gradient then sums the ranks' parts).  Features that
    come out of ``parallel.gather_from_model`` (FedFusion's fused features) go to
    :func:`head_apply` as they are: the gather's backward sums them."""
    return copy_to_model(feats, tp.mp) if head_split(cfg, tp) else feats


def head_apply(cfg: ArchConfig, params, feats, tp=None):
    """Logits of ``feats``; under ``tp`` with the head split on V, this
    rank's block of them (``feats`` must come through :func:`head_input`
    or a ``gather_from_model``).  Under FSDP the head's block split on d
    over ``data`` is not gathered where each data rank holds its share of
    the rows: the rank multiplies its d columns of every rank's rows
    (``parallel.columns_of_rows``) by its block and the partial logits are
    summed over ``data`` onto their rows (``parallel.sum_onto_rows``), so
    the step moves logits, not the head; elsewhere the block is gathered."""
    tied = cfg.tie_embeddings
    w = params["embed"]["table"] if tied else params["head"]["w"]
    spec = None if tp is None else (tp.model_specs["embed"]["table"] if tied
                                    else tp.model_specs["head"]["w"])
    if tp is not None and tp.data_rows and data_dim(spec) == int(tied):
        return sum_onto_rows(columns_of_rows(feats, tp.mp)
                             @ (w.T if tied else w), tp.mp)
    w = _leaf(tp, w, spec)
    return feats @ (w.T if tied else w)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def cache_struct(cfg: ArchConfig, batch: int, max_len: int):
    """The cache tree's leaf shapes (``torch.Size``), as ``init_cache``
    makes them on one device: what ``launch.sharding.cache_shardings``
    reads."""
    c, n_full, rem = cycle_split(cfg.block_pattern)

    def layer(kind):
        if kind == SSD:
            d_inner = cfg.ssm_expand * cfg.d_model
            return {"h": torch.Size((batch, d_inner // cfg.ssm_head_dim,
                                     cfg.ssm_head_dim, cfg.ssm_state)),
                    "conv": torch.Size((batch, cfg.ssm_conv_width - 1,
                                        d_inner + 2 * cfg.ssm_state))}
        if kind == RGLRU:     # the JAX block's conv width, 4
            return {"h": torch.Size((batch, cfg.lru_width)),
                    "conv": torch.Size((batch, 3, cfg.lru_width))}
        L = max_len if kind == ATTN_GLOBAL else min(cfg.sliding_window,
                                                    max_len)
        shape = torch.Size((batch, L, cfg.n_kv_heads, cfg.head_dim))
        out = {"k": shape, "v": shape}
        if cfg.n_enc_layers:        # the cross cache: every audio frame
            out["xk"] = out["xv"] = torch.Size(
                (batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.head_dim))
        return out

    cycles = tuple({n: torch.Size((n_full,) + tuple(t)) for n, t in
                    layer(cfg.block_pattern[j]).items()} for j in range(c))
    tail = tuple(layer(cfg.block_pattern[n_full * c + j]) for j in range(rem))
    return {"cycles": cycles, "tail": tail}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, tp=None):
    """Zero caches on ``device`` (None: the card), shaped as
    :func:`cache_struct`.  Each leaf is its own zeroed tensor, never a
    broadcast view: ``decode_step`` writes into it in place.  Under ``tp``
    (with ``cache_specs`` for this ``batch`` and ``max_len``) each leaf is
    this rank's block: its share of the batch and of the cache length.
    The recurrent states ``h`` are float32 whatever ``dtype``, as in the
    JAX package."""
    _check_supported(cfg, tp)
    device = resolve_device(device)

    def zeros(path, shape):
        if tp is not None:
            spec = tp.cache_specs
            for p in path:
                spec = spec[p]
            shape = [d // tp.mp.place(spec_axes(e))[1]
                     for d, e in zip(shape, spec)]
        return torch.zeros(shape, device=device, dtype=torch.float32
                           if path[-1] == "h" else dtype)

    return tree_with_path(zeros, cache_struct(cfg, batch, max_len))


def decode_step(cfg: ArchConfig, params, tokens, cache, pos, tp=None):
    """tokens [B,1] int; pos the position of this token (an int or a 0-d
    int tensor; best on the device, so a step needs no host copy), below
    the cache length.

    Returns (logits [B,1,V], cache), the cache updated in place.  Under
    ``tp`` (with ``cache_specs``) the logits are this rank's V block and
    the cache its block (module docstring).
    """
    _check_supported(cfg, tp)
    if tp is not None and tp.cache_specs is None:
        raise ValueError("decode_step under tp needs the cache's specs "
                         "(tp.cache_specs: launch.steps.build_serve_step)")
    h = _embed_tokens(params, tokens, tp)
    pos = torch.as_tensor(pos, device=h.device).long().reshape(())
    if cfg.family == "audio":
        h = h + sinusoidal_position_at(pos, cfg.d_model, h.dtype)
    positions = pos.expand(h.shape[0], 1)
    mrope_pos = positions.expand(3, -1, -1) if cfg.mrope else None
    c, n_full, rem = cycle_split(cfg.block_pattern)
    for i in range(n_full):
        for j, kind in enumerate(cfg.block_pattern[:c]):
            p = tree_map(lambda x: x[i], params["cycles"][j])
            layer_cache = tree_map(lambda x: x[i], cache["cycles"][j])
            ps, cs = _layer_parts(tp, True, j)
            h, _ = _layer_decode(cfg, kind, p, h, layer_cache, pos=pos,
                                 positions=positions, tp=tp, ps=ps,
                                 cache_spec=cs, mrope_pos=mrope_pos)
    for j in range(rem):
        kind = cfg.block_pattern[n_full * c + j]
        ps, cs = _layer_parts(tp, False, j)
        h, _ = _layer_decode(cfg, kind, params["tail"][j], h,
                             cache["tail"][j], pos=pos, positions=positions,
                             tp=tp, ps=ps, cache_spec=cs,
                             mrope_pos=mrope_pos)
    feats = norm_apply(_norm_kind(cfg), params["final_norm"], h, cfg.norm_eps)
    return head_apply(cfg, params, head_input(cfg, feats, tp), tp), cache
