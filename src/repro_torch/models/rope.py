"""Rotary position embeddings: standard, partial-rotary and Qwen2-VL's
M-RoPE (port of ``repro/models/rope.py``)."""
from __future__ import annotations

import itertools

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


def mrope_angles(positions_3d, head_dim, theta, sections):
    """Qwen2-VL multimodal RoPE.

    positions_3d: [3, B, S] (temporal, height, width position ids).
    sections: per-axis number of rotary *pairs*, sums to head_dim//2.
    Returns cos/sin [B, S, head_dim//2] where frequency slot j uses the
    position id of the section it falls in.
    """
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim//2 = {half}")
    dev = positions_3d.device
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=dev) / half))
    # the section of each slot, from device ops on Python bounds only (no
    # host-to-device copy: a captured decode step computes it)
    slot = torch.arange(half, device=dev)
    sec_id = torch.zeros_like(slot)
    for end in itertools.accumulate(sections[:-1]):
        sec_id += slot >= end
    # each slot's position stream: [half, B, S] -> [B, S, half]
    pos = positions_3d.index_select(0, sec_id).movedim(0, -1).float()
    ang = pos * freq
    return torch.cos(ang), torch.sin(ang)


def apply_mrope(q, k, positions_3d, *, theta, head_dim, sections):
    """q [B,S,H,hd], k [B,S,KV,hd], positions_3d [3,B,S]."""
    cos, sin = mrope_angles(positions_3d, head_dim, theta, sections)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)
