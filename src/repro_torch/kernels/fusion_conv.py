"""FedFusion `conv` operator (port of ``repro/kernels/fusion_conv.py``).

    out = E_g @ W[:C] + E_l @ W[C:]      (paper Eq. 6, no concatenation)

``w`` may also be a column block ``[2C, N]`` of the operator (a
tensor-parallel rank's, ``N = C / m``): the output is then ``[..., N]``.

``fusion_conv`` is differentiable in all three inputs.  Its forward runs
the CUDA kernel ``csrc/fusion_conv.cu`` for tensors on the card, tiled by
:func:`conv_plan`, and :func:`fusion_conv_plain` for tensors on the CPU;
its backward is the two plain products dE = dO W_{g|l}^T and
dW = [E_g; E_l]^T dO.  The Pallas
kernel defines no VJP, so there is no TPU backward kernel to port; a
backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.calls import kernel_entry, runs_plain


def fusion_conv_plain(f_g, f_l, w):
    """f_g, f_l [..., C]; w [2C, N] -> [..., N] in plain PyTorch."""
    C = f_g.shape[-1]
    return f_g @ w[:C] + f_l @ w[C:]


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One of K2's tilings (``csrc/fusion_conv.cu`` ``Small`` / ``Large``):
    blocks of ``tokens`` x ``channels`` outputs; K = 2C walked in slices
    of ``k_slice``, each slice's depth split evenly among ``k_split``
    thread groups, whose sums are added in group order at the end."""
    plan: int            # the kernel's plan argument
    tokens: int
    channels: int
    k_slice: int
    k_split: int

    def blocks(self, T, C):
        return -(-T // self.tokens) * -(-C // self.channels)

    def group_depths(self, C, group):
        """The depths k in [0, 2C) that thread group ``group`` sums."""
        q = self.k_slice // self.k_split
        return [k for s in range(0, 2 * C, self.k_slice)
                for k in range(s + group * q, s + (group + 1) * q)
                if k < 2 * C]


SMALL = ConvPlan(0, 16, 32, 32, 4)
LARGE = ConvPlan(1, 128, 64, 16, 1)


@functools.lru_cache(maxsize=256)
def conv_plan(T, N, n_sm=132):
    """K2's tiling for an output [T, N] (``N`` = C, or a column block's
    width) on a card of ``n_sm`` SMs: the large tiles where they give
    every SM a block, else the small ones."""
    return LARGE if LARGE.blocks(T, N) >= n_sm else SMALL


@functools.cache
def _kernel():
    lib = build.load("fusion_conv")
    fn = lib.fusion_conv_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fusion_conv_cuda(f_g, f_l, w):
    """Launches ``csrc/fusion_conv.cu``: f_g, f_l [..., C] and w [2C, N],
    contiguous float32 on one CUDA device -> [..., N], tiled by
    :func:`conv_plan` and launched by :func:`build.launch`."""
    if f_g.device.type != "cuda":
        raise ValueError(
            f"fusion_conv_cuda needs CUDA tensors, got {f_g.device}")
    C = f_g.shape[-1]
    N = w.shape[-1] if w.dim() == 2 else 0
    for name, t in (("f_g", f_g), ("f_l", f_l), ("w", w)):
        if t.device != f_g.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"fusion_conv_cuda: {name} must be contiguous float32 on "
                f"{f_g.device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if f_l.shape != f_g.shape or tuple(w.shape) != (2 * C, N):
        raise ValueError(
            f"fusion_conv_cuda: shapes f_g {tuple(f_g.shape)}, f_l "
            f"{tuple(f_l.shape)}, w {tuple(w.shape)} (want [..., C], "
            f"[..., C], [2C, N])")
    T = f_g.numel() // C if C else 0
    if T == 0 or C == 0 or N == 0:
        raise ValueError(f"fusion_conv_cuda: empty input {tuple(f_g.shape)}")
    if f_g.numel() >= 2 ** 31:
        raise ValueError(f"fusion_conv_cuda: {tuple(f_g.shape)} too large")
    plan = conv_plan(T, N, build.sm_count(f_g.device.index)).plan
    out = f_g.new_empty(f_g.shape[:-1] + (N,))
    build.launch("fusion_conv", _kernel(), f_g.device, f_g.data_ptr(),
                 f_l.data_ptr(), w.data_ptr(), out.data_ptr(), T, C, N, plan)
    fusion_conv_cuda.launches += 1
    return out


fusion_conv_cuda.launches = 0


@kernel_entry("fusion_conv")
def _fusion_conv_forward(f_g, f_l, w):
    """K2 on the card, its plain version for tensors on the CPU."""
    if runs_plain(f_g):
        return fusion_conv_plain(f_g, f_l, w)
    return fusion_conv_cuda(f_g, f_l, w)


class FusionConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f_g, f_l, w):
        ctx.save_for_backward(f_g, f_l, w)
        return _fusion_conv_forward(f_g, f_l, w)

    @staticmethod
    def backward(ctx, g):
        f_g, f_l, w = ctx.saved_tensors
        C = f_g.shape[-1]
        g2 = g.reshape(-1, w.shape[-1])
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
