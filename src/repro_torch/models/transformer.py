"""The transformer family's dense attention stack (port of
``repro/models/transformer.py``): global and sliding-window GQA layers in
any local:global pattern, RoPE, RMS norm, SwiGLU or GELU MLPs, tied or
separate heads, prefill (``forward_seq(..., want_cache=True)``) and KV-cache
decode (``decode_step``).

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
no path; the port hands it K9 through the ``kernel=`` hook made for it.
That is the one deliberate difference: the same function, decode attention
over the cache up to its valid length.  ``attn_impl == "jnp"`` runs plain
attention in torch ops.

``decode_step`` updates the cache **in place** (the new key and value are
written into their slot; the returned cache is the same tensors), where the
JAX package returns a new cache from ``dynamic_update_slice``.

``forward_seq`` trains: gradients reach the stacked ``cycles`` leaves
through the per-cycle indexing, and under ``attn_impl == "pallas"`` the
attention backward is K8b / K8c (``kernels/flash_attn.py``).

Not ported yet, and refused with ``NotImplementedError``: MoE FFNs, SSD and
RG-LRU blocks, the encoder and cross-attention, VLM and audio inputs
(M-RoPE, stub embeddings), and ``remat`` (ROADMAP Queue 1, slice 6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import make_flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, norm_apply, norm_init)
from repro_torch.models.rope import apply_rope
from repro_torch.tree import tree_map

_LATER = "(ROADMAP Queue 1, slice 6: the other model families)"


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported "
                                  f"yet {_LATER}")
    bad = sorted(set(cfg.block_pattern) - {ATTN_GLOBAL, ATTN_LOCAL})
    if bad:
        raise NotImplementedError(f"{cfg.name}: blocks {bad} (SSD / RG-LRU) "
                                  f"are not ported yet {_LATER}")
    if cfg.n_enc_layers:
        raise NotImplementedError(f"{cfg.name}: the encoder and "
                                  f"cross-attention are not ported yet "
                                  f"{_LATER}")
    if cfg.family in ("vlm", "audio") or cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: {cfg.family} inputs are not "
                                  f"ported yet {_LATER}")
    if cfg.remat != "none":
        raise NotImplementedError(f"{cfg.name}: remat={cfg.remat!r} is not "
                                  "ported yet (ROADMAP Queue 1, slice 6: "
                                  "activation checkpointing)")


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


def _layer_init(generator, cfg: ArchConfig, dtype):
    nk = _norm_kind(cfg)
    dev = generator.device
    return {
        "ln1": norm_init(nk, cfg.d_model, dtype, dev),
        "attn": attn.attn_init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, dtype),
        "ln2": norm_init(nk, cfg.d_model, dtype, dev),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def _layer_cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      dtype, device):
    L = max_len if kind == ATTN_GLOBAL else min(cfg.sliding_window, max_len)
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _apply_rope_any(cfg: ArchConfig, q, k, positions):
    if cfg.rope_theta <= 0:
        return q, k
    return apply_rope(q, k, positions, theta=cfg.rope_theta,
                      head_dim=cfg.head_dim,
                      partial_pct=cfg.partial_rotary_pct)


def _layer_seq(cfg: ArchConfig, kind: str, p, h, *, positions, want_cache,
               max_len):
    """Sequence-mode attention layer. Returns (h, cache_or_None)."""
    nk = _norm_kind(cfg)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], hn, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim)
    q, k = _apply_rope_any(cfg, q, k, positions)
    window = cfg.sliding_window if kind == ATTN_LOCAL else None
    if cfg.attn_impl == "pallas":
        o = make_flash_attention(causal=True, window=window)(q, k, v)
    else:
        o = attn.flash_attention(q, k, v, window=window)
    h = h + attn.project_out(p["attn"], o)
    cache = _seq_kv_to_cache(cfg, kind, k, v, max_len) if want_cache \
        else None
    hn2 = norm_apply(nk, p["ln2"], h, cfg.norm_eps)
    return h + mlp_apply(p["ffn"], hn2, cfg.act), cache


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


def _layer_decode(cfg: ArchConfig, kind: str, p, h, cache, *, pos,
                  positions):
    """Decode-mode attention layer: h [B,1,d], pos a 0-d int64 tensor on
    h's device.  Writes the new K/V into ``cache`` in place; returns
    (h, cache)."""
    nk = _norm_kind(cfg)
    hn = norm_apply(nk, p["ln1"], h, cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], hn, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim)
    q, k = _apply_rope_any(cfg, q, k, positions)
    L = cache["k"].shape[1]
    slot = (pos % L if kind == ATTN_LOCAL else pos).reshape(1)
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    valid = torch.clamp(pos + 1, max=L)
    kernel = ops.gqa_flash_decode if cfg.attn_impl == "pallas" else None
    o = attn.decode_attention(q, cache["k"], cache["v"], cache_len=valid,
                              kernel=kernel)
    h = h + attn.project_out(p["attn"], o)
    hn2 = norm_apply(nk, p["ln2"], h, cfg.norm_eps)
    return h + mlp_apply(p["ffn"], hn2, cfg.act), cache


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
    cycles = []
    for j in range(c):
        cycles.append(_stack([_layer_init(generator, cfg, dtype)
                              for _ in range(n_full)]))
    tail = tuple(_layer_init(generator, cfg, dtype) for _ in range(rem))
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
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Forward: sequence mode (prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch):
    # F.embedding, not ``table[tokens]``: the indexing backward on the CPU
    # (index_put_ with accumulate) adds the rows of repeated tokens in a
    # thread-dependent order, so two equal calls could differ by an ulp;
    # embedding's backward (index_add_) adds them in index order
    return F.embedding(batch["tokens"], params["embed"]["table"])


def forward_seq(cfg: ArchConfig, params, batch, *, want_cache=False,
                want_logits=True, max_cache_len: Optional[int] = None):
    """batch: {'tokens': [B,S] int} -> {'logits'?, 'features', 'aux',
    'cache'?}; runs on the parameters' device."""
    _check_supported(cfg)
    h = _embed_inputs(cfg, params, batch)
    S = h.shape[1]
    max_len = max_cache_len or S
    positions = torch.arange(S, device=h.device)
    c, n_full, rem = cycle_split(cfg.block_pattern)
    caches = [[] for _ in range(c)]
    for i in range(n_full):
        for j, kind in enumerate(cfg.block_pattern[:c]):
            p = tree_map(lambda x: x[i], params["cycles"][j])
            h, cache = _layer_seq(cfg, kind, p, h, positions=positions,
                                  want_cache=want_cache, max_len=max_len)
            caches[j].append(cache)
    tail_caches = []
    for j in range(rem):
        kind = cfg.block_pattern[n_full * c + j]
        h, cache = _layer_seq(cfg, kind, params["tail"][j], h,
                              positions=positions, want_cache=want_cache,
                              max_len=max_len)
        tail_caches.append(cache)

    feats = norm_apply(_norm_kind(cfg), params["final_norm"], h, cfg.norm_eps)
    out = {"features": feats,
           "aux": torch.zeros((), dtype=torch.float32, device=h.device)}
    if want_logits:
        out["logits"] = head_apply(cfg, params, feats)
    if want_cache:
        out["cache"] = {"cycles": tuple(_stack(cs) for cs in caches),
                        "tail": tuple(tail_caches)}
    return out


def head_apply(cfg: ArchConfig, params, feats):
    if cfg.tie_embeddings:
        return feats @ params["embed"]["table"].T
    return feats @ params["head"]["w"]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """Zero caches on ``device`` (None: the card).  Each stacked cycle
    leaf is its own zeroed tensor, never a broadcast view: ``decode_step``
    writes into it in place."""
    _check_supported(cfg)
    device = resolve_device(device)
    c, n_full, rem = cycle_split(cfg.block_pattern)
    cycles = tuple(
        _stack([_layer_cache_init(cfg, cfg.block_pattern[j], batch, max_len,
                                  dtype, device) for _ in range(n_full)])
        for j in range(c))
    tail = tuple(_layer_cache_init(cfg, cfg.block_pattern[n_full * c + j],
                                   batch, max_len, dtype, device)
                 for j in range(rem))
    return {"cycles": cycles, "tail": tail}


def decode_step(cfg: ArchConfig, params, tokens, cache, pos):
    """tokens [B,1] int; pos the position of this token (an int or a 0-d
    int tensor; best on the device, so a step needs no host copy), below
    the cache length.

    Returns (logits [B,1,V], cache), the cache updated in place.
    """
    _check_supported(cfg)
    h = params["embed"]["table"][tokens]
    pos = torch.as_tensor(pos, device=h.device).long().reshape(())
    positions = pos.expand(h.shape[0], 1)
    c, n_full, rem = cycle_split(cfg.block_pattern)
    for i in range(n_full):
        for j, kind in enumerate(cfg.block_pattern[:c]):
            p = tree_map(lambda x: x[i], params["cycles"][j])
            layer_cache = tree_map(lambda x: x[i], cache["cycles"][j])
            h, _ = _layer_decode(cfg, kind, p, h, layer_cache, pos=pos,
                                 positions=positions)
    for j in range(rem):
        kind = cfg.block_pattern[n_full * c + j]
        h, _ = _layer_decode(cfg, kind, params["tail"][j], h,
                             cache["tail"][j], pos=pos, positions=positions)
    feats = norm_apply(_norm_kind(cfg), params["final_norm"], h, cfg.norm_eps)
    return head_apply(cfg, params, feats), cache
