"""Plain PyTorch oracles for the ported kernels (port of
``repro/kernels/ref.py``, K1 to K7, K8a and K9).  They define the
semantics the kernels and :mod:`repro_torch.kernels.ops` are held to; the
per-kernel plain versions live beside each kernel (``gram_sum_plain``,
``fusion_conv_plain``, ``flash_fwd_plain``, ``flash_decode_plain``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import flash_decode_plain
from repro_torch.kernels.flash_attn import flash_fwd_plain
from repro_torch.kernels.fusion_conv import fusion_conv_plain

__all__ = ["mk_mmd2_ref", "fusion_conv_ref", "quant_pack_ref",
           "quant_unpack_ref", "topk_select_ref", "ef_gather_ref",
           "ef_scatter_ref", "flash_fwd_ref", "decode_attn_ref"]


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


def quant_pack_ref(x, scale, noise, *, bits):
    """Fused stochastic-quantize + pack oracle (the codecs' wire format).

    x [n] float; scale a scalar (the wire step size); noise [n] in [0, 1),
    the stochastic-rounding offsets (0.5 = deterministic round-half-up).
    ``bits=8``: int8 codes in [-127, 127].  ``bits=4``: codes in [-7, 7]
    stored as ``code + 8`` nibbles, two per uint8 (element 2i in the low
    nibble, 2i+1 in the high one); n must be even.
    """
    if bits not in (4, 8):
        raise ValueError(f"quant_pack_ref bits={bits!r} must be 4 or 8")
    qmax = 127 if bits == 8 else 7
    q = torch.floor(x.float() / scale + noise).clamp(-qmax, qmax)
    if bits == 8:
        return q.to(torch.int8)
    u = (q + 8).to(torch.uint8).reshape(-1, 2)
    return u[:, 0] | (u[:, 1] << 4)


def quant_unpack_ref(packed, scale, *, bits, n):
    """Inverse of :func:`quant_pack_ref`: packed codes -> float32 [n]."""
    if bits not in (4, 8):
        raise ValueError(f"quant_unpack_ref bits={bits!r} must be 4 or 8")
    if bits == 8:
        return packed.float() * scale
    low = (packed & 0xF).to(torch.int32) - 8
    high = ((packed >> 4) & 0xF).to(torch.int32) - 8
    q = torch.stack((low, high), -1).reshape(-1)[:n]
    return q.float() * scale


def topk_select_ref(x, thresh):
    """Magnitude threshold select: keep x where |x| >= thresh, else 0.
    With thresh = the k-th largest |x| this is the dense form of top-k
    sparsification (the decode of the topk codec's encode)."""
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


def ef_gather_ref(table, idx):
    """Row gather of the error-feedback table: table [N, ...] (one row per
    federation client), idx [k] int (the round's sampled client ids) ->
    the [k, ...] rows the round fn threads as per-client EF state."""
    return table.index_select(0, idx)


def ef_scatter_ref(table, idx, rows):
    """Row scatter, in place: writes rows [k, ...] into table [N, ...] at
    idx and returns the table.  ``idx`` must be unique (the sampler
    asserts it) except for a scratch row whose contents are discarded;
    with duplicates one of the writes wins, in no set order."""
    return table.index_copy_(0, idx.long(), rows)


# GQA flash attention forward (K8a): (o, lse [B, KV, rep, S]) of causal /
# sliding-window attention; GQA flash-decode (K9): one query token against
# a [B, L, KV, hd] cache, positions >= valid_len masked.  Both the masked
# full softmax in float32.
flash_fwd_ref = flash_fwd_plain
decode_attn_ref = flash_decode_plain
