"""The wire codecs' kernels and the EF table's row movers (port of
``repro/kernels/compress_pack.py``: K3 ``quant_pack``, K4 ``quant_unpack``,
K5 ``topk_select``, K6 ``ef_gather`` and K7 ``ef_scatter``).

    quant_pack    q = clip(floor(x / scale + u), +-qmax) as int8 codes, or
                  as ``code + 8`` nibbles two per uint8 (element 2i low)
    quant_unpack  codes -> float32 code * scale
    topk_select   x where |x| >= t, else 0
    ef_gather     rows idx[j] of a [N, ...] table -> [k, ...]
    ef_scatter    rows [k, ...] written into the table at idx, in place

Each function runs its CUDA kernel (``csrc/compress_pack.cu`` for K3–K5,
``csrc/ef_rows.cu`` for K6 and K7) for tensors on the card and its plain
PyTorch version for tensors on the CPU; the two are bit-identical.
``scale`` and ``thresh`` are one-element float32 tensors on the data's
device, and the EF ids stay on the device, so the host never reads them.
No gradients: the codecs work on deltas after training.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["quant_pack", "quant_unpack", "topk_select", "ef_gather",
           "ef_scatter", "quant_pack_plain", "quant_unpack_plain",
           "topk_select_plain", "ef_gather_plain", "ef_scatter_plain",
           "quant_pack_cuda", "quant_unpack_cuda", "topk_select_cuda",
           "ef_gather_cuda", "ef_scatter_cuda"]


def _check_bits(name, bits):
    if bits not in (4, 8):
        raise ValueError(f"{name} bits={bits!r} must be 4 or 8")


def _unpack_n(packed, bits, n):
    m = packed.shape[0]
    cap = m if bits == 8 else 2 * m
    n = cap if n is None else int(n)
    if not 0 <= n <= cap:
        raise ValueError(f"quant_unpack: n={n} outside [0, {cap}] for "
                         f"{m} packed bytes at {bits} bits")
    return n


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def quant_pack_plain(x, scale, noise, *, bits=8):
    """x [n], noise [n] in [0, 1), scale [1] -> int8 [n] (bits 8) or uint8
    [n/2] (bits 4, n even), in plain PyTorch."""
    _check_bits("quant_pack", bits)
    if bits == 4 and x.shape[0] % 2:
        raise ValueError(f"int4 pack needs an even element count, got "
                         f"{x.shape[0]}")
    qmax = 127 if bits == 8 else 7
    q = torch.floor(x.float() / scale.reshape(1) + noise.float())
    q = q.clamp(-qmax, qmax)
    if bits == 8:
        return q.to(torch.int8)
    u = (q + 8).to(torch.uint8).reshape(-1, 2)
    return u[:, 0] | (u[:, 1] << 4)


def quant_unpack_plain(packed, scale, *, bits=8, n=None):
    """Inverse of :func:`quant_pack_plain`: codes -> float32 [n]."""
    _check_bits("quant_unpack", bits)
    n = _unpack_n(packed, bits, n)
    if bits == 8:
        q = packed[:n]
    else:
        low = (packed & 0xF).to(torch.int32) - 8
        high = ((packed >> 4) & 0xF).to(torch.int32) - 8
        q = torch.stack((low, high), -1).reshape(-1)[:n]
    return q.float() * scale.reshape(1)


def topk_select_plain(x, thresh):
    """x [n], thresh [1] -> x where |x| >= thresh, else 0."""
    return torch.where(x.abs() >= thresh.reshape(1), x, torch.zeros_like(x))


def ef_gather_plain(table, idx):
    """table [N, ...], idx [k] int -> rows idx as [k, ...]."""
    return table.index_select(0, idx)


def ef_scatter_plain(table, idx, rows):
    """Writes rows [k, ...] into table [N, ...] at idx, in place; returns
    the table."""
    return table.index_copy_(0, idx.long(), rows)


# --------------------------------------------------------------------------
# CUDA launchers
# --------------------------------------------------------------------------

@functools.cache
def _kernels():
    lib = build.load("compress_pack")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.quant_pack_f32.argtypes = [p, p, p, p, ll, i, i, p]
    lib.quant_unpack_f32.argtypes = [p, p, p, ll, i, i, p]
    lib.topk_select_f32.argtypes = [p, p, p, ll, i, p]
    for fn in (lib.quant_pack_f32, lib.quant_unpack_f32, lib.topk_select_f32):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _ef_kernels():
    lib = build.load("ef_rows")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ef_gather_f32.argtypes = [p, p, i, p, ll, ll, i, p]
    lib.ef_scatter_f32.argtypes = [p, p, i, p, ll, ll, i, p]
    for fn in (lib.ef_gather_f32, lib.ef_scatter_f32):
        fn.restype = ctypes.c_int
    return lib


def _check(kernel, name, t, device, dtype, numel=None):
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {name} on "
                         f"{t.device}")
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous 1-D {dtype} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{kernel}: {name} has {t.numel()} elements, "
                         f"want {numel}")


def _aligned(*pairs):
    """1 when every (tensor, bytes) pair's data is aligned to bytes."""
    return int(all(t.data_ptr() % a == 0 for t, a in pairs))


def _launch(kernel, fn, device, *args):
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def quant_pack_cuda(x, scale, noise, *, bits=8):
    """Launches K3: x, noise float32 [n] and scale float32 [1], contiguous
    on one CUDA device -> int8 [n] or uint8 [n/2]."""
    _check_bits("quant_pack_cuda", bits)
    dev = x.device
    _check("quant_pack_cuda", "x", x, dev, torch.float32)
    n = x.numel()
    _check("quant_pack_cuda", "noise", noise, dev, torch.float32, n)
    _check("quant_pack_cuda", "scale", scale, dev, torch.float32, 1)
    if n == 0 or (bits == 4 and n % 2):
        raise ValueError(f"quant_pack_cuda: n={n} must be positive (and "
                         "even for bits=4)")
    out = torch.empty(n if bits == 8 else n // 2, device=dev,
                      dtype=torch.int8 if bits == 8 else torch.uint8)
    vec = _aligned((x, 16), (noise, 16), (out, 4))
    _launch("quant_pack", _kernels().quant_pack_f32, dev, x.data_ptr(),
            noise.data_ptr(), scale.data_ptr(), out.data_ptr(), n, bits, vec)
    quant_pack_cuda.launches += 1
    return out


quant_pack_cuda.launches = 0


def quant_unpack_cuda(packed, scale, *, bits=8, n=None):
    """Launches K4: packed int8 [n] (bits 8) or uint8 [m >= n/2] (bits 4)
    and scale float32 [1], contiguous on one CUDA device -> float32 [n]."""
    _check_bits("quant_unpack_cuda", bits)
    dev = packed.device
    _check("quant_unpack_cuda", "packed", packed, dev,
           torch.int8 if bits == 8 else torch.uint8)
    _check("quant_unpack_cuda", "scale", scale, dev, torch.float32, 1)
    n = _unpack_n(packed, bits, n)
    if n == 0:
        raise ValueError("quant_unpack_cuda: n must be positive")
    out = torch.empty(n, device=dev, dtype=torch.float32)
    vec = _aligned((packed, 4), (out, 16))
    _launch("quant_unpack", _kernels().quant_unpack_f32, dev,
            packed.data_ptr(), scale.data_ptr(), out.data_ptr(), n, bits, vec)
    quant_unpack_cuda.launches += 1
    return out


quant_unpack_cuda.launches = 0


def topk_select_cuda(x, thresh):
    """Launches K5: x float32 [n] and thresh float32 [1], contiguous on one
    CUDA device -> float32 [n]."""
    dev = x.device
    _check("topk_select_cuda", "x", x, dev, torch.float32)
    _check("topk_select_cuda", "thresh", thresh, dev, torch.float32, 1)
    n = x.numel()
    if n == 0:
        raise ValueError("topk_select_cuda: empty input")
    out = torch.empty_like(x)
    vec = _aligned((x, 16), (out, 16))
    _launch("topk_select", _kernels().topk_select_f32, dev, x.data_ptr(),
            thresh.data_ptr(), out.data_ptr(), n, vec)
    topk_select_cuda.launches += 1
    return out


topk_select_cuda.launches = 0

_EF_MAX_ROWS = 65535       # the kernels' grid.y holds one id each


def _ef_table(kernel, table):
    """The table's row length n (elements per row) after the checks."""
    if table.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got table on "
                         f"{table.device}")
    if table.dtype != torch.float32 or table.dim() < 1 \
            or not table.is_contiguous():
        raise ValueError(
            f"{kernel}: table must be a contiguous float32 [N, ...] tensor, "
            f"got {table.dtype} {tuple(table.shape)} "
            f"(contiguous={table.is_contiguous()})")
    n = 1
    for d in table.shape[1:]:
        n *= d
    return n


def _ef_ids(kernel, idx, table):
    """idx as a contiguous 1-D int32/int64 tensor on the table's device.
    Ids given on the CPU are range-checked here; ids on the card are the
    caller's contract (the kernels read them on the device only)."""
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{kernel}: idx must be a 1-D int32 or int64 "
                         f"tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.numel() > _EF_MAX_ROWS:
        raise ValueError(f"{kernel}: {idx.numel()} ids, at most "
                         f"{_EF_MAX_ROWS}")
    if idx.device.type == "cpu":
        n_rows = table.shape[0]
        if idx.numel() and not (0 <= int(idx.min()) and
                                int(idx.max()) < n_rows):
            raise IndexError(f"{kernel}: ids outside [0, {n_rows})")
        idx = idx.to(table.device)
    elif idx.device != table.device:
        raise ValueError(f"{kernel}: idx on {idx.device}, table on "
                         f"{table.device}")
    return idx.contiguous()


def ef_gather_cuda(table, idx):
    """Launches K6: table float32 [N, ...] contiguous on a CUDA device,
    idx [k] int32/int64 -> rows idx as a new [k, ...] tensor."""
    n = _ef_table("ef_gather_cuda", table)
    idx = _ef_ids("ef_gather_cuda", idx, table)
    k = idx.numel()
    out = torch.empty((k,) + tuple(table.shape[1:]), device=table.device,
                      dtype=torch.float32)
    if k == 0 or n == 0:
        return out
    vec = int(n % 4 == 0) * _aligned((table, 16), (out, 16))
    _launch("ef_gather", _ef_kernels().ef_gather_f32, table.device,
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            out.data_ptr(), k, n, vec)
    ef_gather_cuda.launches += 1
    return out


ef_gather_cuda.launches = 0


def ef_scatter_cuda(table, idx, rows):
    """Launches K7: writes rows float32 [k, ...] into table float32 [N, ...]
    (contiguous, on a CUDA device) at idx, in place: only the k selected
    rows are written, the table keeps its storage.  Returns the table."""
    n = _ef_table("ef_scatter_cuda", table)
    idx = _ef_ids("ef_scatter_cuda", idx, table)
    k = idx.numel()
    want = (k,) + tuple(table.shape[1:])
    if rows.device != table.device or rows.dtype != torch.float32 \
            or tuple(rows.shape) != want or not rows.is_contiguous():
        raise ValueError(
            f"ef_scatter_cuda: rows must be a contiguous float32 {want} "
            f"tensor on {table.device}, got {rows.dtype} "
            f"{tuple(rows.shape)} on {rows.device} "
            f"(contiguous={rows.is_contiguous()})")
    if k == 0 or n == 0:
        return table
    vec = int(n % 4 == 0) * _aligned((table, 16), (rows, 16))
    _launch("ef_scatter", _ef_kernels().ef_scatter_f32, table.device,
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            rows.data_ptr(), k, n, vec)
    ef_scatter_cuda.launches += 1
    return table


ef_scatter_cuda.launches = 0


# --------------------------------------------------------------------------
# dispatch: the plain version for CPU tensors only
# --------------------------------------------------------------------------

def quant_pack(x, scale, noise, *, bits=8):
    """K3 on the card, its plain version for tensors on the CPU."""
    if x.device.type == "cpu":
        return quant_pack_plain(x, scale, noise, bits=bits)
    return quant_pack_cuda(x, scale, noise, bits=bits)


def quant_unpack(packed, scale, *, bits=8, n=None):
    """K4 on the card, its plain version for tensors on the CPU."""
    if packed.device.type == "cpu":
        return quant_unpack_plain(packed, scale, bits=bits, n=n)
    return quant_unpack_cuda(packed, scale, bits=bits, n=n)


def topk_select(x, thresh):
    """K5 on the card, its plain version for tensors on the CPU."""
    if x.device.type == "cpu":
        return topk_select_plain(x, thresh)
    return topk_select_cuda(x, thresh)


def ef_gather(table, idx):
    """K6 on the card, its plain version for tensors on the CPU."""
    if table.device.type == "cpu":
        return ef_gather_plain(table, idx)
    return ef_gather_cuda(table, idx)


def ef_scatter(table, idx, rows):
    """K7 on the card (in place), its plain version for tensors on the
    CPU; returns the table."""
    if table.device.type == "cpu":
        return ef_scatter_plain(table, idx, rows)
    return ef_scatter_cuda(table, idx, rows)
