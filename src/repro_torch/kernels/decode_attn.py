"""GQA flash-decode, K9 (port of ``repro/kernels/decode_attn.py``).

``flash_decode(q, k_cache, v_cache, valid_len)``: one query token
q [B,1,H,hd] against caches [B,L,KV,hd] (H = KV * rep, any rep), cache
positions >= ``valid_len`` masked -> [B,1,H,hd].  Tensors on the card run
the CUDA kernel ``csrc/decode_attn.cu`` in one launch (the cache length
cut into slices by :func:`decode_plan`, staged into shared memory, the
slices merged in a fixed order by the last block of each group); tensors
on the CPU run :func:`flash_decode_plain`, a masked full softmax in
float32.

On the card ``valid_len`` is best an int32 or int64 tensor on the device:
the kernel reads it there, so the wrapper neither casts it nor
synchronises with the host.  A Python int travels as a kernel argument.

``want_lse=True`` also returns each row's log-sum-exp, lse [B, H] float32
(one store a row in the kernel): a cache cut into slices over ranks
(``repro_torch.models.transformer``'s sequence-sharded decode) gives one
``(o, lse)`` pair a slice, and :func:`merge_partials` combines them into
the whole call's output.  ``valid_len`` may be 0 (a slice with no valid
position yet): the kernel then returns o = 0 and lse = -1e30, the plain
version the mean of v and lse = -1e30 + log L; either way the slice's
merge weight ``exp(lse - max)`` is 0, and nothing is NaN.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.calls import kernel_entry, runs_plain
from repro_torch.kernels.flash_attn import masked_softmax_attention

# the head dims the kernel is built for: every one the repository's configs
# use; any other is refused
HEAD_DIMS = (64, 80, 120, 128, 256)
MAX_GROUPS = 65535          # B * KV: the kernel's grid.y holds one group each
MIN_SLICE_BYTES = 32 * 1024  # K + V bytes a block stages, at least
MAX_SLICE_BYTES = 64 * 1024  # ... and at most
BLOCKS_PER_SM = 2           # the grid that fills the card once
SMEM_LIMIT = 231424         # dynamic shared memory a block may take (an
                            # H100's 232,448 less 1 KB for static bytes)
MIN_CHUNK = 8               # slices a first-level merge takes, at least

class DecodePlan(NamedTuple):
    split: int          # cache positions per slice (one block each)
    n_split: int        # slices per (b, kv head) group: the grid's x
    groups: int         # B * KV: the grid's y
    smem_bytes: int     # dynamic shared memory a block takes


def flash_decode_plain(q, k_cache, v_cache, valid_len=None, *,
                       want_lse=False):
    """[B,1,H,hd] in plain PyTorch: the masked full softmax in float32
    (and, with ``want_lse``, each row's log-sum-exp [B, H])."""
    L = k_cache.shape[1]
    mask = torch.arange(L, device=q.device) < (L if valid_len is None
                                                else valid_len)
    o, lse = masked_softmax_attention(q, k_cache, v_cache, mask[None, :])
    if not want_lse:
        return o
    return o, lse.reshape(q.shape[0], q.shape[2])


def merge_partials(o_parts, lse_parts):
    """The decode attention of a whole cache from its slices' partials:
    o_parts [n, B, 1, H, hd] and lse_parts [n, B, H] (one pair a slice, in
    any order) -> o [B, 1, H, hd], each slice weighted by ``exp(lse -
    max)`` over the slices.  A slice with no valid position (lse near
    -1e30) weighs 0."""
    top = lse_parts.max(dim=0, keepdim=True).values
    w = torch.exp(lse_parts - top)                        # [n, B, H]
    num = (w[:, :, None, :, None] * o_parts.float()).sum(0)
    return (num / w.sum(0)[:, None, :, None]).to(o_parts.dtype)


@functools.lru_cache(maxsize=256)
def decode_plan(B, L, KV, rep, hd, sm_count):
    """The slices of one K9 call: enough blocks to fill a card of
    ``sm_count`` SMs once (``BLOCKS_PER_SM`` blocks an SM), each staging at
    least ``MIN_SLICE_BYTES`` of K and V where L allows and at most
    ``MAX_SLICE_BYTES``, and as few slices as that gives.  Pure
    arithmetic, so it runs (and is tested) on the CPU."""
    if hd not in HEAD_DIMS or min(B, L, KV, rep, sm_count) < 1:
        raise ValueError(f"decode_plan: B={B}, L={L}, KV={KV}, rep={rep}, "
                         f"hd={hd}, sm_count={sm_count} (want positive "
                         f"sizes and hd in {HEAD_DIMS}, the head dims K9 "
                         f"is built for)")
    groups = B * KV
    if groups > MAX_GROUPS:
        raise ValueError(f"decode_plan: B * KV = {groups} > {MAX_GROUPS}")
    row = 8 * hd                           # one K row and one V row
    lo = -(-MIN_SLICE_BYTES // row)
    hi = MAX_SLICE_BYTES // row
    want = -(-groups * L // (BLOCKS_PER_SM * sm_count))
    split = min(L, max(lo, min(hi, want)))
    n_split = -(-L // split)
    smem = 4 * (2 * split * hd + rep * split + 2 * rep)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode_plan: rep={rep} needs {smem} bytes of "
                         f"shared memory a block (> {SMEM_LIMIT})")
    return DecodePlan(split, n_split, groups, smem)


@functools.cache
def _kernel():
    lib = build.load("decode_attn")
    fn = lib.flash_decode_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


_TICKETS = {}
_OUTGROWN = []      # smaller ticket buffers a captured graph may still use


def _tickets(device, count):
    """At least ``count`` int32 zeros on ``device``: the tickets of the
    two-level merge, made (or grown) outside a CUDA-graph capture and kept
    (each call leaves its tickets zero again)."""
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode_cuda: a call of this size must first run "
                "outside CUDA-graph capture (it makes the ticket buffer)")
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros(max(count, MAX_GROUPS), dtype=torch.int32,
                        device=device)
        torch.cuda.synchronize(device)     # zero before any stream reads it
        _TICKETS[device.index] = t
    return t


def _check_cache(name, t, dev):
    if t.device != dev or t.dtype != torch.float32 or t.dim() != 4 \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"flash_decode_cuda: {name} must be a contiguous, 16-byte "
            f"aligned 4-d float32 tensor on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous="
            f"{t.is_contiguous()})")


def flash_decode_cuda(q, k_cache, v_cache, valid_len=None, *, split=None,
                      want_lse=False):
    """Launches ``csrc/decode_attn.cu`` once: q [B,1,H,hd], caches
    [B,L,KV,hd], contiguous 16-byte aligned float32 on one CUDA device, hd
    in ``HEAD_DIMS``, any rep = H / KV; ``valid_len`` one int32 or int64
    on the same device, an int, or None (= L); 0 is allowed.  ``split``
    overrides the plan's positions per slice (tests).  Returns o, or
    ``(o, lse [B, H])`` with ``want_lse``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, got {dev}")
    _check_cache("q", q, dev)
    _check_cache("k_cache", k_cache, dev)
    _check_cache("v_cache", v_cache, dev)
    B, one, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, L, KV, hd) \
            or v_cache.shape != k_cache.shape or KV < 1 or H % KV \
            or hd not in HEAD_DIMS or L < 1 or B * KV > MAX_GROUPS:
        raise ValueError(
            f"flash_decode_cuda: shapes q {tuple(q.shape)}, k_cache "
            f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)} (want "
            f"[B,1,KV*rep,hd], [B,L,KV,hd] with hd in {HEAD_DIMS}, the head "
            f"dims K9 is built for)")
    if k_cache.numel() >= 2 ** 31:
        raise ValueError(
            f"flash_decode_cuda: {tuple(k_cache.shape)} too large")
    if valid_len is None:
        kind, ptr, host = 0, None, L
    elif isinstance(valid_len, torch.Tensor):
        if valid_len.device != dev or valid_len.numel() != 1 \
                or valid_len.dtype not in (torch.int32, torch.int64):
            raise ValueError(
                f"flash_decode_cuda: valid_len must be one int32 or int64 on "
                f"{dev}, got {valid_len.dtype} {tuple(valid_len.shape)} on "
                f"{valid_len.device}")
        kind = 1 if valid_len.dtype == torch.int32 else 2
        ptr, host = valid_len.data_ptr(), 0
    else:
        kind, ptr, host = 0, None, max(0, min(int(valid_len), L))
    rep = H // KV
    if split is None:
        split = decode_plan(B, L, KV, rep, hd, build.sm_count(dev.index)).split
    n_split = -(-L // split)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if want_lse else None)
    scratch, tickets = None, None
    if n_split > 1:
        chunks = -(-n_split // MIN_CHUNK)
        scratch = torch.empty(B * KV * (n_split + chunks) * rep * (hd + 2),
                              dtype=torch.float32, device=dev)
        tickets = _tickets(dev, B * KV * (chunks + 1)).data_ptr()
    build.launch("flash_decode", _kernel(), dev, q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), ptr,
                 kind, host, o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), tickets,
                 B, L, H, KV, hd, split)
    flash_decode_cuda.launches += 1
    return (o, lse) if want_lse else o


flash_decode_cuda.launches = 0


@kernel_entry("flash_decode")
def flash_decode(q, k_cache, v_cache, valid_len=None, *, want_lse=False):
    """q [B,1,H,hd]; caches [B,L,KV,hd] -> [B,1,H,hd] (and lse [B, H] with
    ``want_lse``): the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  ``valid_len``: an int, an int tensor
    or None (= L)."""
    if runs_plain(q):
        return flash_decode_plain(q, k_cache, v_cache, valid_len,
                                  want_lse=want_lse)
    return flash_decode_cuda(q, k_cache, v_cache, valid_len,
                             want_lse=want_lse)
