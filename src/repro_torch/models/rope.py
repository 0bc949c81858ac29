"""Rotary position embeddings, standard and partial-rotary (port of
``repro/models/rope.py``).  Qwen2-VL's M-RoPE comes with the VLM family."""
from __future__ import annotations

import torch


def rope_angles(positions, head_dim_rot, theta):
    """positions [..., S] -> (cos, sin) of shape [..., S, head_dim_rot//2]."""
    half = head_dim_rot // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotates the first 2*half dims of x (split-halves convention).

    x: [..., S, H, hd]; cos/sin: [..., S, half] broadcast over heads.
    """
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = (x1 * c - x2 * s, x2 * c + x1 * s, x[..., 2 * half:])
    return torch.cat(out, dim=-1).to(x.dtype)


def apply_rope(q, k, positions, *, theta, head_dim, partial_pct=1.0):
    """q [B,S,H,hd], k [B,S,KV,hd], positions [B,S] (or [S])."""
    rot = int(head_dim * partial_pct)
    rot -= rot % 2
    if rot == 0 or theta <= 0:
        return q, k
    cos, sin = rope_angles(positions, rot, theta)   # [B,S,half]
    if cos.ndim == 2:                               # [S,half] -> [1,S,half]
        cos, sin = cos[None], sin[None]
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def apply_mrope(q, k, positions_3d, *, theta, head_dim, sections):
    raise NotImplementedError(
        "M-RoPE (Qwen2-VL) is not ported: it comes with the VLM family in "
        "the LM training slice (ROADMAP Queue 1, slice 6)")
