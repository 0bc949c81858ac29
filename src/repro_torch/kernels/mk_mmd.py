"""Multi-width RBF Gram sum for MK-MMD (port of ``repro/kernels/mk_mmd.py``).

    S(x, y) = sum_{i<n, j<m} mean_w exp(-max(d2_ij, 0) / (2 w sigma))

``gram_sum`` is differentiable in x and y (sigma is a stop-grad input, as
in the loss).  Its forward runs the CUDA kernel ``csrc/gram_sum.cu`` for
tensors on the card and :func:`gram_sum_plain` for tensors on the CPU; its
backward is the closed form

    dS/dx_i = sum_j k'(d2_ij) 2 (x_i - y_j),  dS/dy_j = sum_i k'(d2_ij) 2 (y_j - x_i)

in PyTorch ops.  The Pallas kernel defines no VJP at all, so there is no
TPU backward kernel to port; a backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_WIDTHS = 8
_TILE = 32          # rows per block in csrc/gram_sum.cu
_MAX_GRID_Y = 65535


def gram_sum_plain(x, y, sigma, widths):
    """The kernel's arithmetic in plain PyTorch (the reference on any
    device): d2 by the norm identity, clamped at 0, summed over pairs."""
    x = x.float()
    y = y.float()
    d2 = ((x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
          - 2.0 * (x @ y.T)).clamp_min(0.0)
    acc = sum(torch.exp(-d2 / (2.0 * w * sigma)) for w in widths)
    return acc.sum() / len(widths)


@functools.cache
def _kernel():
    lib = build.load("gram_sum")
    fn = lib.gram_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, device, ndim):
    if t.device != device or t.dtype != torch.float32 or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"gram_sum_cuda: {name} must be a contiguous float32 "
            f"{ndim}-D tensor on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


def gram_sum_cuda(x, y, sigma, widths: Sequence[float]):
    """Launches ``csrc/gram_sum.cu``: x [n, d], y [m, d], sigma a
    one-element tensor, all float32 on one CUDA device -> 0-d tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"gram_sum_cuda needs CUDA tensors, got {x.device}")
    _check("x", x, x.device, 2)
    _check("y", y, x.device, 2)
    _check("sigma", sigma.reshape(1), x.device, 1)
    widths = tuple(float(w) for w in widths)
    if not 1 <= len(widths) <= MAX_WIDTHS:
        raise ValueError(f"gram_sum_cuda takes 1..{MAX_WIDTHS} widths, got "
                         f"{len(widths)}")
    (n, d), (m, d_y) = x.shape, y.shape
    if d != d_y or n == 0 or m == 0 or d == 0:
        raise ValueError(f"gram_sum_cuda: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} do not match or are empty")
    grid_x, grid_y = -(-n // _TILE), -(-m // _TILE)
    if grid_y > _MAX_GRID_Y or max(n, m, d) >= 2 ** 31:
        raise ValueError(f"gram_sum_cuda: ({n}, {m}, {d}) is too large")
    fn = _kernel()
    partials = torch.empty(grid_x * grid_y, device=x.device,
                           dtype=torch.float32)
    out = torch.empty((), device=x.device, dtype=torch.float32)
    c_widths = (ctypes.c_float * len(widths))(*widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                partials.data_ptr(), out.data_ptr(), n, m, d, c_widths,
                len(widths), stream)
    if rc != 0:
        raise RuntimeError(f"gram_sum kernel launch failed: CUDA error {rc}")
    gram_sum_cuda.launches += 1
    return out


gram_sum_cuda.launches = 0


class GramSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, sigma, widths):
        ctx.widths = widths
        ctx.save_for_backward(x, y, sigma)
        if x.device.type == "cpu":
            return gram_sum_plain(x, y, sigma, widths)
        return gram_sum_cuda(x, y, sigma, widths)

    @staticmethod
    def backward(ctx, g):
        x, y, sigma = ctx.saved_tensors
        d2 = ((x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
              - 2.0 * (x @ y.T)).clamp_min(0.0)
        # dS/dd2, summed over widths and divided by their count
        kp = sum(torch.exp(-d2 / (2.0 * w * sigma)) * (-1.0 / (2.0 * w * sigma))
                 for w in ctx.widths) / len(ctx.widths)
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = 2.0 * g * (kp.sum(1)[:, None] * x - kp @ y)
        if ctx.needs_input_grad[1]:
            gy = 2.0 * g * (kp.sum(0)[:, None] * y - kp.T @ x)
        return gx, gy, None, None


def gram_sum(x, y, sigma, widths):
    """Differentiable S(x, y): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    return GramSum.apply(x, y, sigma, tuple(float(w) for w in widths))
