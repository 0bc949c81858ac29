"""GQA flash-decode, K9 (port of ``repro/kernels/decode_attn.py``).

``flash_decode(q, k_cache, v_cache, valid_len)``: one query token
q [B,1,H,hd] against caches [B,L,KV,hd] (H = KV * rep), cache positions
>= ``valid_len`` masked -> [B,1,H,hd].  Tensors on the card run the CUDA
kernel ``csrc/decode_attn.cu`` (the cache length split across blocks, a
fixed-order combine pass); tensors on the CPU run
:func:`flash_decode_plain`, a masked full softmax in float32.

On the card ``valid_len`` is best an int32 tensor on the device: the
kernel reads it there, so the wrapper never synchronises with the host
(a Python int is copied to the device first).  ``valid_len`` must be at
least 1.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import masked_softmax_attention

HEAD_DIMS = (64, 128, 256)
MAX_REP = 8         # query heads per KV head held in registers
MAX_SPLIT = 64      # cache positions per block


def flash_decode_plain(q, k_cache, v_cache, valid_len=None):
    """[B,1,H,hd] in plain PyTorch: the masked full softmax in float32."""
    L = k_cache.shape[1]
    mask = torch.arange(L, device=q.device) < (L if valid_len is None
                                                else valid_len)
    return masked_softmax_attention(q, k_cache, v_cache, mask[None, :])[0]


@functools.cache
def _kernel():
    lib = build.load("decode_attn")
    fn = lib.flash_decode_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_len(B, L, KV, sm_count):
    """Cache positions per block: enough blocks for two per SM on a card of
    ``sm_count`` SMs, 16 to 64 positions each."""
    return max(16, min(MAX_SPLIT, math.ceil(B * L * KV / (2 * sm_count))))


def flash_decode_cuda(q, k_cache, v_cache, valid_len):
    """Launches ``csrc/decode_attn.cu``: q [B,1,H,hd], caches [B,L,KV,hd],
    contiguous float32 on one CUDA device, hd in {64, 128, 256},
    1 <= H/KV <= 8; ``valid_len`` one int32 on the same device."""
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_decode_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 4:
            raise ValueError(
                f"flash_decode_cuda: {name} must be a contiguous 4-d float32 "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if valid_len.device != q.device or valid_len.dtype != torch.int32 \
            or valid_len.numel() != 1:
        raise ValueError(
            f"flash_decode_cuda: valid_len must be one int32 on {q.device}, "
            f"got {valid_len.dtype} {tuple(valid_len.shape)} on "
            f"{valid_len.device}")
    B, one, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, L, KV, hd) \
            or v_cache.shape != k_cache.shape or KV < 1 or H % KV \
            or not 1 <= H // KV <= MAX_REP or hd not in HEAD_DIMS or L < 1:
        raise ValueError(
            f"flash_decode_cuda: shapes q {tuple(q.shape)}, k_cache "
            f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)} (want "
            f"[B,1,KV*rep,hd], [B,L,KV,hd] with hd in {HEAD_DIMS} and "
            f"1 <= rep <= {MAX_REP})")
    if k_cache.numel() >= 2 ** 31:
        raise ValueError(
            f"flash_decode_cuda: {tuple(k_cache.shape)} too large")
    split = split_len(B, L, KV, _sm_count(q.device))
    n_split = -(-L // split)
    rep = H // KV
    fn = _kernel()
    o = torch.empty_like(q)
    pm = torch.empty((B, KV, n_split, rep), dtype=torch.float32,
                     device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, KV, n_split, rep, hd), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                valid_len.data_ptr(), o.data_ptr(), pm.data_ptr(),
                pl.data_ptr(), pacc.data_ptr(), B, L, H, KV, hd, split,
                float(hd ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: CUDA error {rc}")
    flash_decode_cuda.launches += 1
    return o


flash_decode_cuda.launches = 0


def flash_decode(q, k_cache, v_cache, valid_len=None):
    """q [B,1,H,hd]; caches [B,L,KV,hd] -> [B,1,H,hd]: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU.
    ``valid_len``: an int, an int tensor or None (= L)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, valid_len)
    if valid_len is None:
        valid_len = k_cache.shape[1]
    valid = torch.as_tensor(valid_len, device=q.device).to(torch.int32)
    return flash_decode_cuda(q, k_cache, v_cache, valid.reshape(1))
