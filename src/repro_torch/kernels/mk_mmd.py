"""Multi-width RBF Gram sum and the MK-MMD term (port of
``repro/kernels/mk_mmd.py`` and of ``mk_mmd2`` in ``repro/kernels/ops.py``).

    S(x, y) = sum_{i<n, j<m} mean_w exp(-max(d2_ij, 0) / (2 w sigma))
    MMD^2   = S(x, x) / n^2 + S(y, y) / m^2 - 2 S(x, y) / (n m)

with sigma the stop-grad mean of the unclamped cross d2, + 1e-8.

``mk_mmd2`` is the term as one ``torch.autograd.Function``
(:class:`MkMmd2`): on the card for n, m <= 64 rows, one launch of the
fused kernel forward (``mk_mmd2_fwd_kernel`` in ``csrc/gram_sum.cu``:
sigma, the three sums and the result) and one backward (dx, and dy only
when it is asked for); on the CPU :func:`mk_mmd2_plain` and
:func:`mk_mmd2_grad_plain`, the same formulas in plain PyTorch.  Larger n
or m on the card take :func:`mk_mmd2_gram`: sigma in PyTorch ops and three
``gram_sum`` calls, whose forward runs the two-pass Gram-sum kernel and
whose backward is the closed form

    dS/dx_i = sum_j k'(d2_ij) 2 (x_i - y_j),  dS/dy_j = sum_i k'(d2_ij) 2 (y_j - x_i)

in PyTorch ops.  The route is chosen by shape, never as a fallback.  The
Pallas kernel defines no VJP at all, so the backward kernel has no TPU
kernel of its own to port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_WIDTHS = 8
FUSED_MAX_ROWS = 64  # n, m the fused term takes (csrc/gram_sum.cu)
_TILE = 32          # rows per block in csrc/gram_sum.cu
_MAX_GRID_Y = 65535


def _sqdist(a, b):
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
            - 2.0 * (a @ b.T))


def _kprime(d2, sigma, widths):
    """d/d(d2) of mean_w exp(-d2 / (2 w sigma)), at d2 clamped at 0."""
    d2 = d2.clamp_min(0.0)
    return sum(torch.exp(-d2 / (2.0 * w * sigma)) * (-1.0 / (2.0 * w * sigma))
               for w in widths) / len(widths)


def gram_sum_plain(x, y, sigma, widths):
    """The kernel's arithmetic in plain PyTorch (the reference on any
    device): d2 by the norm identity, clamped at 0, summed over pairs."""
    d2 = _sqdist(x.float(), y.float()).clamp_min(0.0)
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
        kp = _kprime(_sqdist(x, y), sigma, ctx.widths)
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


# --------------------------------------------------------------------------
# the MK-MMD term
# --------------------------------------------------------------------------

def mk_mmd2_plain(x, y, widths):
    """(MMD^2, sigma) of x [n, d], y [m, d] in plain PyTorch, as the fused
    kernel computes them: sigma the mean of the unclamped cross d2 + 1e-8
    (detached), each Gram sum over d2 clamped at 0."""
    x, y = x.float(), y.float()
    n, m = x.shape[0], y.shape[0]
    dxy = _sqdist(x, y)
    sigma = dxy.mean().detach() + 1e-8

    def total(d2):
        d2 = d2.clamp_min(0.0)
        return sum(torch.exp(-d2 / (2.0 * w * sigma))
                   for w in widths).sum() / len(widths)

    value = (total(_sqdist(x, x)) / (n * n) + total(_sqdist(y, y)) / (m * m)
             - 2.0 * total(dxy) / (n * m))
    return value, sigma


def mk_mmd2_grad_plain(x, y, sigma, g, widths, need_dx=True, need_dy=True):
    """(dx, dy) of g * MMD^2 in plain PyTorch, in the closed form the fused
    backward kernel computes (None where not asked for):

        dx_i = g [4/n^2 sum_j k'xx_ij (x_i - x_j)
                  - 4/(nm) sum_j k'xy_ij (x_i - y_j)]
        dy_j = g [4/m^2 sum_l k'yy_jl (y_j - y_l)
                  - 4/(nm) sum_i k'xy_ij (y_j - x_i)]
    """
    x, y = x.float(), y.float()
    n, m = x.shape[0], y.shape[0]
    kxy = _kprime(_sqdist(x, y), sigma, widths)
    dx = dy = None
    if need_dx:
        kxx = _kprime(_sqdist(x, x), sigma, widths)
        dx = (4.0 * g / (n * n) * (kxx.sum(1)[:, None] * x - kxx @ x)
              - 4.0 * g / (n * m) * (kxy.sum(1)[:, None] * x - kxy @ y))
    if need_dy:
        kyy = _kprime(_sqdist(y, y), sigma, widths)
        dy = (4.0 * g / (m * m) * (kyy.sum(1)[:, None] * y - kyy @ y)
              - 4.0 * g / (n * m) * (kxy.sum(0)[:, None] * y - kxy.T @ x))
    return dx, dy


@functools.cache
def _fused_kernels():
    lib = build.load("gram_sum")
    fwd, bwd = lib.mk_mmd2_fwd_f32, lib.mk_mmd2_bwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.cache
def _c_widths(widths):
    """The widths as a ctypes float array, one per tuple."""
    if not 1 <= len(widths) <= MAX_WIDTHS:
        raise ValueError(f"mk_mmd2 takes 1..{MAX_WIDTHS} widths, got "
                         f"{len(widths)}")
    return (ctypes.c_float * len(widths))(*widths)


def _fused_shape(fn, x, y):
    """(n, m, d) of x [n, d], y [m, d] under the fused kernels' contract:
    contiguous float32 on one CUDA device, 1 <= n, m <= 64, d >= 1."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device or t.dtype != torch.float32 \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous float32 2-D tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    (n, d), (m, d_y) = x.shape, y.shape
    if d != d_y or not (1 <= n <= FUSED_MAX_ROWS and 1 <= m <= FUSED_MAX_ROWS
                        and 1 <= d < 2 ** 31 // FUSED_MAX_ROWS):
        raise ValueError(f"{fn}: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} (want [n, d] and [m, d] with 1 "
                         f"<= n, m <= {FUSED_MAX_ROWS}, d >= 1)")
    return n, m, d


def mk_mmd2_cuda(x, y, widths):
    """Launches the fused forward (``csrc/gram_sum.cu``) once: x [n, d], y
    [m, d] -> a float32 [2] tensor holding MMD^2 and sigma."""
    n, m, d = _fused_shape("mk_mmd2_cuda", x, y)
    c_widths = _c_widths(tuple(widths))
    out = torch.empty(2, device=x.device, dtype=torch.float32)
    build.launch("mk_mmd2", _fused_kernels()[0], x.device, x.data_ptr(),
                 y.data_ptr(), out.data_ptr(), n, m, d, c_widths,
                 len(c_widths))
    mk_mmd2_cuda.launches += 1
    return out


mk_mmd2_cuda.launches = 0


def mk_mmd2_grad_cuda(x, y, sigma, g, widths, need_dx=True, need_dy=True):
    """Launches the fused backward once: sigma and g one-element float32
    tensors on the card (the forward's sigma, dLoss / dMMD^2) -> (dx, dy),
    None where not asked for."""
    n, m, d = _fused_shape("mk_mmd2_grad_cuda", x, y)
    for name, t in (("sigma", sigma), ("g", g)):
        if t.device != x.device or t.dtype != torch.float32 \
                or t.numel() != 1:
            raise ValueError(f"mk_mmd2_grad_cuda: {name} must be one float32 "
                             f"on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    c_widths = _c_widths(tuple(widths))
    dx = torch.empty_like(x) if need_dx else None
    dy = torch.empty_like(y) if need_dy else None
    build.launch("mk_mmd2_grad", _fused_kernels()[1], x.device, x.data_ptr(),
                 y.data_ptr(), sigma.data_ptr(), g.data_ptr(),
                 None if dx is None else dx.data_ptr(),
                 None if dy is None else dy.data_ptr(), n, m, d, c_widths,
                 len(c_widths))
    mk_mmd2_grad_cuda.launches += 1
    return dx, dy


mk_mmd2_grad_cuda.launches = 0


class MkMmd2(torch.autograd.Function):
    """MMD^2(x, y) with sigma a stop-grad input: the fused kernels on the
    card (one launch each way), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, y, widths):
        if x.device.type == "cpu":
            value, sigma = mk_mmd2_plain(x, y, widths)
        else:
            out = mk_mmd2_cuda(x, y, widths)
            value, sigma = out[0], out[1:]
        ctx.widths = widths
        ctx.save_for_backward(x, y, sigma)
        return value

    @staticmethod
    def backward(ctx, g):
        x, y, sigma = ctx.saved_tensors
        need_dx, need_dy = ctx.needs_input_grad[:2]
        if x.device.type == "cpu":
            dx, dy = mk_mmd2_grad_plain(x, y, sigma, g, ctx.widths, need_dx,
                                        need_dy)
        else:
            dx, dy = mk_mmd2_grad_cuda(x, y, sigma, g.reshape(1).contiguous(),
                                       ctx.widths, need_dx, need_dy)
        return dx, dy, None


def mk_mmd2_gram(x, y, widths):
    """MMD^2 through three :func:`gram_sum` calls (the route for n or m
    above 64 on the card): sigma in PyTorch ops, the closed-form backward
    per Gram sum."""
    n, m = x.shape[0], y.shape[0]
    sigma = _sqdist(x, y).mean().detach() + 1e-8
    sxx = gram_sum(x, x, sigma, widths)
    syy = gram_sum(y, y, sigma, widths)
    sxy = gram_sum(x, y, sigma, widths)
    return sxx / (n * n) + syy / (m * m) - 2.0 * sxy / (n * m)


def mk_mmd2(x, y, widths):
    """Differentiable MMD^2 of x [n, d], y [m, d] (float32, contiguous):
    :class:`MkMmd2`, except on the card for n or m above 64, which takes
    :func:`mk_mmd2_gram`."""
    widths = tuple(float(w) for w in widths)
    if x.device.type == "cuda" and max(x.shape[0], y.shape[0]) \
            > FUSED_MAX_ROWS:
        return mk_mmd2_gram(x, y, widths)
    return MkMmd2.apply(x, y, widths)
