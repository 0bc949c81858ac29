"""FedFusion `conv` operator (port of ``repro/kernels/fusion_conv.py``).

    out = E_g @ W[:C] + E_l @ W[C:]      (paper Eq. 6, no concatenation)

``fusion_conv`` is differentiable in all three inputs.  Its forward runs
the CUDA kernel ``csrc/fusion_conv.cu`` for tensors on the card and
:func:`fusion_conv_plain` for tensors on the CPU; its backward is the two
plain products dE = dO W_{g|l}^T and dW = [E_g; E_l]^T dO.  The Pallas
kernel defines no VJP, so there is no TPU backward kernel to port; a
backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def fusion_conv_plain(f_g, f_l, w):
    """f_g, f_l [..., C]; w [2C, C] -> [..., C] in plain PyTorch."""
    C = f_g.shape[-1]
    return f_g @ w[:C] + f_l @ w[C:]


@functools.cache
def _kernel():
    lib = build.load("fusion_conv")
    fn = lib.fusion_conv_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fusion_conv_cuda(f_g, f_l, w):
    """Launches ``csrc/fusion_conv.cu``: f_g, f_l [..., C] and w [2C, C],
    contiguous float32 on one CUDA device -> [..., C]."""
    if f_g.device.type != "cuda":
        raise ValueError(
            f"fusion_conv_cuda needs CUDA tensors, got {f_g.device}")
    C = f_g.shape[-1]
    for name, t in (("f_g", f_g), ("f_l", f_l), ("w", w)):
        if t.device != f_g.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"fusion_conv_cuda: {name} must be contiguous float32 on "
                f"{f_g.device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if f_l.shape != f_g.shape or tuple(w.shape) != (2 * C, C):
        raise ValueError(
            f"fusion_conv_cuda: shapes f_g {tuple(f_g.shape)}, f_l "
            f"{tuple(f_l.shape)}, w {tuple(w.shape)} (want [..., C], "
            f"[..., C], [2C, C])")
    T = f_g.numel() // C if C else 0
    if T == 0 or C == 0:
        raise ValueError(f"fusion_conv_cuda: empty input {tuple(f_g.shape)}")
    if f_g.numel() >= 2 ** 31:
        raise ValueError(f"fusion_conv_cuda: {tuple(f_g.shape)} too large")
    fn = _kernel()
    out = torch.empty_like(f_g)
    with torch.cuda.device(f_g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(f_g.data_ptr(), f_l.data_ptr(), w.data_ptr(), out.data_ptr(),
                T, C, stream)
    if rc != 0:
        raise RuntimeError(
            f"fusion_conv kernel launch failed: CUDA error {rc}")
    fusion_conv_cuda.launches += 1
    return out


fusion_conv_cuda.launches = 0


class FusionConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f_g, f_l, w):
        ctx.save_for_backward(f_g, f_l, w)
        if f_g.device.type == "cpu":
            return fusion_conv_plain(f_g, f_l, w)
        return fusion_conv_cuda(f_g, f_l, w)

    @staticmethod
    def backward(ctx, g):
        f_g, f_l, w = ctx.saved_tensors
        C = f_g.shape[-1]
        g2 = g.reshape(-1, C)
        dfg = dfl = dw = None
        if ctx.needs_input_grad[0]:
            dfg = (g2 @ w[:C].T).reshape(f_g.shape)
        if ctx.needs_input_grad[1]:
            dfl = (g2 @ w[C:].T).reshape(f_l.shape)
        if ctx.needs_input_grad[2]:
            dw = torch.cat((f_g.reshape(-1, C).T @ g2,
                            f_l.reshape(-1, C).T @ g2))
        return dfg, dfl, dw


def fusion_conv(f_g, f_l, w):
    """Differentiable fusion conv: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    return FusionConv.apply(f_g, f_l, w)
