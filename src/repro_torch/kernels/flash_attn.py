"""GQA flash attention forward, K8a (port of ``repro/kernels/flash_attn.py``
``flash_fwd`` and ``make_flash_attention``).

``flash_fwd(q, k, v)`` returns ``(o, lse)``: q [B,S,H,hd], k/v [B,S,KV,hd]
with H = KV * rep -> o [B,S,H,hd], lse [B,KV,rep,S] float32 (the JAX
layout pads lse to whole Pallas blocks; here it has exactly S columns).
Causal and sliding-window masks come from position arithmetic.  Tensors on
the card run the CUDA kernel ``csrc/flash_attn.cu``; tensors on the CPU run
:func:`flash_fwd_plain`, a masked full softmax in float32.

``make_flash_attention`` returns ``flash(q, k, v) -> o`` as a
``torch.autograd.Function``.  Its backward is the Pallas package's two
backward kernels (K8b ``dq``, K8c ``dk``/``dv``), which come with the LM
training slice: until then it raises, on the card and on the CPU, rather
than differentiate through the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_REP = 64        # query heads per KV head: the kernel's 64-row tile


def masked_softmax_attention(q, k, v, mask):
    """softmax(q k^T / sqrt(hd), masked) v in float32, and each row's
    log-sum-exp: q [B,Sq,H,hd], k/v [B,Sk,KV,hd], mask [Sq,Sk] bool (True:
    visible) -> (o [B,Sq,H,hd] in q's dtype, lse [B,KV,rep,Sq]).  Masked
    scores take the finite -1e30 JAX uses.  The plain versions of K8a and
    K9 and the models' plain attention are this function."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qh = q.reshape(B, Sq, KV, rep, hd).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k.float()) * hd ** -0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype), lse


def flash_fwd_plain(q, k, v, *, causal=True, window=None):
    """(o, lse) in plain PyTorch: the masked full softmax in float32."""
    pos = torch.arange(q.shape[1], device=q.device)
    mask = torch.ones(len(pos), len(pos), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return masked_softmax_attention(q, k, v, mask)


@functools.cache
def _kernel():
    lib = build.load("flash_attn")
    fn = lib.flash_fwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v, *, causal=True, window=None):
    """Launches ``csrc/flash_attn.cu``: q [B,S,H,hd], k/v [B,S,KV,hd],
    contiguous 16-byte aligned float32 on one CUDA device, hd in
    {64, 128, 256}, 1 <= H/KV <= 64 -> (o [B,S,H,hd], lse [B,KV,H/KV,S])."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 4:
            raise ValueError(
                f"flash_fwd_cuda: {name} must be a contiguous 4-d float32 "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or KV < 1 \
            or H % KV or not 1 <= H // KV <= MAX_REP or hd not in HEAD_DIMS \
            or S < 1 or B < 1:
        raise ValueError(
            f"flash_fwd_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (want [B,S,KV*rep,hd], [B,S,KV,hd] with "
            f"hd in {HEAD_DIMS} and 1 <= rep <= {MAX_REP})")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"flash_fwd_cuda: {tuple(q.shape)} too large")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd_cuda: q, k and v must start 16-byte "
                         "aligned (the kernel reads float4s); pass a copy")
    if window is not None and window < 1:
        raise ValueError(f"flash_fwd_cuda: window={window!r} must be >= 1")
    fn = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((B, KV, H // KV, S), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, S, H, KV, hd, int(causal),
                0 if window is None else int(window), float(hd ** -0.5),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_fwd(q, k, v, *, causal=True, window=None):
    """(o, lse) with scale hd^-0.5: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    return flash_fwd_cuda(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return flash_fwd(q, k, v, causal=causal, window=window)[0]

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "the flash attention backward (K8b dq, K8c dk/dv of "
            "repro/kernels/flash_attn.py) is not ported yet: it comes with "
            "the LM training slice (ROADMAP Queue 1); use attn_impl='jnp' "
            "to train through plain attention")


def make_flash_attention(*, causal=True, window=None):
    """Returns flash(q, k, v) -> o (K8a forward; no backward yet).

    q [B,S,H,hd]; k,v [B,S,KV,hd] with H = KV*rep.
    """
    def flash(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)

    return flash
