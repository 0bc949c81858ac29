"""Public wrappers over the ported kernels (port of
``repro/kernels/ops.py``, K1 to K7 and K9; K8a is reached through
``kernels.flash_attn.make_flash_attention``, as in the JAX package).

There is no ``impl`` switch: each kernel module runs its CUDA kernel for
tensors on the card and its plain version for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import compress_pack
from repro_torch.kernels.decode_attn import flash_decode
from repro_torch.kernels.fusion_conv import fusion_conv
from repro_torch.kernels import mk_mmd


def mk_mmd2(x, y, widths):
    """Multi-kernel squared MMD between feature batches x [n,d], y [m,d] at
    the median-heuristic sigma: on the card one fused launch forward and
    one backward for n, m <= 64, else three Gram sums (xx, yy, xy)."""
    return mk_mmd.mk_mmd2(x.float().contiguous(), y.float().contiguous(),
                          widths)


def fused_fusion_conv(f_g, f_l, w):
    """FedFusion conv operator: W . concat(f_g, f_l) along channels."""
    return fusion_conv(f_g.contiguous(), f_l.contiguous(), w.contiguous())


def _scalar(v, like):
    """``v`` (a number or a tensor) as a float32 [1] tensor on ``like``'s
    device."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(1)


def quantize_pack(x, scale, noise, *, bits=8):
    """Fused stochastic-quantize + bit-pack of a flat float32 tensor: int8
    codes, or nibble-packed uint8 for ``bits=4`` (the wire format of
    ``repro_torch.compress``)."""
    return compress_pack.quant_pack(x.float().contiguous(), _scalar(scale, x),
                                    noise.float().contiguous(), bits=bits)


def quantize_unpack(packed, scale, *, bits=8, n=None):
    """Unpack quantized codes back to float32 [n]."""
    return compress_pack.quant_unpack(packed.contiguous(),
                                      _scalar(scale, packed), bits=bits, n=n)


def topk_threshold_select(x, thresh):
    """Dense top-k select: keep entries with |x| >= thresh, zero the rest."""
    return compress_pack.topk_select(x.float().contiguous(),
                                     _scalar(thresh, x))


def ef_gather(table, idx):
    """Rows ``idx [k]`` of the EF table ``[N, ...]`` as a new ``[k, ...]``
    tensor (K6)."""
    return compress_pack.ef_gather(table, idx)


def ef_scatter(table, idx, rows):
    """Writes ``rows [k, ...]`` into the EF table at ``idx`` in place (K7)
    and returns the table: only the k selected rows are written."""
    return compress_pack.ef_scatter(table, idx, rows)


def gqa_flash_decode(q, k_cache, v_cache, valid_len=None, *,
                     want_lse=False):
    """One-token GQA decode attention against a KV cache (K9): q
    [B,1,H,hd], caches [B,L,KV,hd], positions >= ``valid_len`` masked; with
    ``want_lse`` also each row's log-sum-exp [B, H]."""
    return flash_decode(q.contiguous(), k_cache.contiguous(),
                        v_cache.contiguous(), valid_len, want_lse=want_lse)
