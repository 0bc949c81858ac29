"""The wire codecs' kernels and the EF table's row movers (port of
``repro/kernels/compress_pack.py``: K3 ``quant_pack``, K4 ``quant_unpack``,
K5 ``topk_select``, K6 ``ef_gather`` and K7 ``ef_scatter``).

    quant_pack    q = clip(floor(x / scale + u), +-qmax) as int8 codes, or
                  as ``code + 8`` nibbles two per uint8 (element 2i low);
                  ``quant_pack_multi`` encodes every leaf of a message,
                  scales included, in two launches, at the capacity's qmax
                  or at a ladder level read on the device
    quant_unpack  codes -> float32 code * scale; ``quant_unpack_multi``
                  decodes every leaf of a message in one launch
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

import array
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.calls import kernel_entry, runs_plain

__all__ = ["quant_pack", "quant_pack_multi", "quant_unpack",
           "quant_unpack_multi", "topk_select", "ef_gather", "ef_scatter",
           "quant_pack_plain", "quant_pack_multi_plain",
           "quant_unpack_plain", "quant_unpack_multi_plain",
           "topk_select_plain", "ef_gather_plain", "ef_scatter_plain",
           "quant_pack_cuda", "quant_pack_multi_cuda", "quant_unpack_cuda",
           "quant_unpack_multi_cuda", "topk_select_cuda", "ef_gather_cuda",
           "ef_scatter_cuda", "topk_schedule"]

MAX_LEAVES = 64     # leaves one K3 / K4 launch takes (the kernels' leaf table)
MAX_LADDER = 8      # levels of a quant ladder K3 takes
_F32 = torch.float32


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


def _check_ladder(name, bits, level, ladder_qmax, device=None):
    """What a ladder level must be: a one-element int32 tensor (on
    ``device`` when given) with 1..8 qmax values in (0, capacity]."""
    if level is None:
        return
    cap = 127.0 if bits == 8 else 7.0
    if ladder_qmax is None or not 1 <= len(ladder_qmax) <= MAX_LADDER \
            or not all(0.0 < float(q) <= cap for q in ladder_qmax):
        raise ValueError(f"{name}: a level needs 1 to {MAX_LADDER} ladder "
                         f"qmax values in (0, {cap:g}], got {ladder_qmax!r}")
    if level.dtype != torch.int32 or level.numel() != 1 \
            or (device is not None and level.device != device):
        raise ValueError(f"{name}: level must be a one-element int32 tensor"
                         f"{'' if device is None else f' on {device}'}, got "
                         f"{level.dtype} {tuple(level.shape)} on "
                         f"{level.device}")


def quant_pack_multi_plain(xs, noises, *, bits=8, level=None,
                           ladder_qmax=None):
    """The leaves of a message -> [(codes, scale [1]), ...]: per leaf
    scale = max(max|x|, 1e-12) / qmax and :func:`quant_pack_plain`, with an
    odd int4 leaf padded by one zero and u = 0.5 where ``noises`` (a list of
    offsets, each of the padded length, or None) gives none.  qmax is the
    capacity's (127 or 7) or, with ``level`` (a one-element int32 tensor),
    ``ladder_qmax[level]``; the codes still clip at the capacity."""
    _check_bits("quant_pack_multi", bits)
    _check_ladder("quant_pack_multi", bits, level, ladder_qmax)
    out = []
    for i, x in enumerate(xs):
        u = None if noises is None else noises[i]
        n = x.shape[0]
        pn = n + (n % 2 if bits == 4 else 0)
        if pn != n:
            x = torch.nn.functional.pad(x, (0, pn - n))
        # a tensor divisor: on the card PyTorch multiplies by the
        # reciprocal of a Python-number divisor, which is not the IEEE
        # division of the CPU, of JAX and of the kernel
        if level is None:
            qmax = torch.full((1,), 127.0 if bits == 8 else 7.0,
                              device=x.device)
        else:
            qmax = torch.tensor(
                [float(q) for q in ladder_qmax], device=x.device).index_select(
                    0, level.reshape(1).clamp(0, len(ladder_qmax) - 1)
                    .to(device=x.device, dtype=torch.long))
        scale = x.abs().amax().clamp_min(1e-12).reshape(1) / qmax
        if u is None:
            u = torch.full((pn,), 0.5, device=x.device)
        out.append((quant_pack_plain(x, scale, u, bits=bits), scale))
    return out


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


def quant_unpack_multi_plain(packed, scales, *, bits=8, ns=None):
    """:func:`quant_unpack_plain` over the leaves of a message: packed and
    scales are lists, ns a list of element counts (None: all the codes)."""
    ns = [None] * len(packed) if ns is None else ns
    return [quant_unpack_plain(q, s, bits=bits, n=n)
            for q, s, n in zip(packed, scales, ns)]


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
    lib.quant_pack_multi_f32.argtypes = [p, i, i, p, p, p, i, p]
    lib.quant_unpack_multi_f32.argtypes = [p, i, p]
    lib.topk_select_f32.argtypes = [p, p, p, ll, i, p]
    lib.topk_select_schedule.argtypes = [ll, i, p]
    for fn in (lib.quant_pack_f32, lib.quant_pack_multi_f32,
               lib.quant_unpack_multi_f32, lib.topk_select_f32,
               lib.topk_select_schedule):
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


_FNS = {}


def _fn(name):
    """The ctypes function ``name``, looked up once."""
    fn = _FNS.get(name)
    if fn is None:
        lib = _ef_kernels() if name.startswith("ef_") else _kernels()
        fn = _FNS[name] = getattr(lib, name)
    return fn


def _check(kernel, name, t, device, dtype, numel=None):
    """What the C side cannot check: a contiguous 1-D tensor of ``dtype``
    on ``device`` (a CUDA device), of ``numel`` elements if given."""
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous() \
            or (numel is not None and t.numel() != numel):
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} needs CUDA tensors, got {name} on "
                             f"{t.device}")
        want = "" if numel is None else f" of {numel} elements"
        raise ValueError(
            f"{kernel}: {name} must be a contiguous 1-D {dtype} tensor{want} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _cuda_device(kernel, t):
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {t.device}")
    return t.device


def _aligned(*pairs):
    """1 when every (tensor, bytes) pair's data is aligned to bytes."""
    return int(all(t.data_ptr() % a == 0 for t, a in pairs))


def quant_pack_cuda(x, scale, noise, *, bits=8):
    """Launches K3: x, noise float32 [n] and scale float32 [1], contiguous
    on one CUDA device -> int8 [n] or uint8 [n/2]."""
    _check_bits("quant_pack_cuda", bits)
    dev = _cuda_device("quant_pack_cuda", x)
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
    build.launch("quant_pack", _fn("quant_pack_f32"), dev, x.data_ptr(),
            noise.data_ptr(), scale.data_ptr(), out.data_ptr(), n, bits, vec)
    quant_pack_cuda.launches += 1
    return out


quant_pack_cuda.launches = 0

_SLOTS = {}


def _pack_slots(dev):
    """The device's K3 slots (64 max|x| bits, 64 tickets), int32 zeros made
    once (each message leaves them zero), so the first message on a device
    must be encoded outside a CUDA-graph capture."""
    t = _SLOTS.get(dev.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "quant_pack_multi_cuda: the first call on a device must run "
                "outside CUDA-graph capture (it makes the K3 slots)")
        t = torch.zeros(2 * MAX_LEAVES, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)        # zero before any stream reads it
        _SLOTS[dev.index] = t
    return t


@functools.cache
def _ladder_array(ladder_qmax):
    """The ladder's qmax values as a host float array for the C side."""
    return (ctypes.c_float * len(ladder_qmax))(*ladder_qmax)


def quant_pack_multi_cuda(xs, noises, *, bits=8, level=None,
                          ladder_qmax=None):
    """K3 over the leaves of a message: xs float32 [n] leaves, noises their
    offsets (float32, of length n, or n + 1 for an odd int4 leaf) or None
    (u = 0.5), contiguous on one CUDA device.  Each leaf's scale is
    max(max|x|, 1e-12) / qmax, computed on the device, with qmax the
    capacity's or, with ``level`` (a one-element int32 tensor on the same
    device), ``ladder_qmax[level]``: the kernel reads the level on the
    device, so a captured graph replays at whatever level the buffer holds.
    Two launches per 64 leaves (max|x| and the scales, then the codes),
    each counted on ``quant_pack_cuda``; no other device op.  Returns
    [(codes, scale), ...]: the codes (int8 [n], or uint8 [ceil(n / 2)]) as
    views of one buffer, each leaf starting 16-byte aligned, and the scales
    as [1] views of one float32 buffer."""
    _check_bits("quant_pack_multi_cuda", bits)
    n_leaves = len(xs)
    if not n_leaves or (noises is not None and len(noises) != n_leaves):
        raise ValueError(f"quant_pack_multi_cuda: {n_leaves} leaves and "
                         f"{None if noises is None else len(noises)} offsets")
    dev = _cuda_device("quant_pack_multi_cuda", xs[0])
    f32 = torch.float32
    # per leaf: x, u, codes offset (made an address below), scale index, n,
    # vec
    table, split, keep, total = [], [], [], 0
    for i, x in enumerate(xs):
        if x.dtype != f32 or x.device != dev or x.dim() != 1 \
                or not x.is_contiguous():
            _check("quant_pack_multi_cuda", f"xs[{i}]", x, dev, f32)
        n = x.numel()
        if n == 0:
            raise ValueError(f"quant_pack_multi_cuda: leaf {i} is empty")
        pn = n + (n % 2 if bits == 4 else 0)
        u = None if noises is None else noises[i]
        u_ptr = 0
        if u is not None:
            if u.dtype != f32 or u.device != dev or u.dim() != 1 \
                    or not u.is_contiguous() or u.numel() != pn:
                _check("quant_pack_multi_cuda", f"noises[{i}]", u, dev, f32,
                       pn)
            u_ptr = u.data_ptr()
        x_ptr = x.data_ptr()
        table += (x_ptr, u_ptr, total, i, n, (x_ptr | u_ptr) % 16 == 0)
        m = pn if bits == 8 else pn // 2
        pad = -m % 16 if i + 1 < n_leaves else 0   # next leaf 16-byte aligned
        split += (m, pad) if pad else (m,)
        keep += (True, False) if pad else (True,)
        total += m + pad
    codes = torch.empty(total, device=dev,
                        dtype=torch.int8 if bits == 8 else torch.uint8)
    scales = torch.empty(n_leaves, device=dev, dtype=f32)
    base, s_base = codes.data_ptr(), scales.data_ptr()
    for j in range(2, len(table), 6):
        table[j] += base
        table[j + 1] = s_base + 4 * table[j + 1]
        table[j + 3] = table[j + 3] and base % 4 == 0
    level_ptr, ladder, n_levels = 0, None, 0
    if level is not None:
        _check_ladder("quant_pack_multi_cuda", bits, level, ladder_qmax, dev)
        ladder = _ladder_array(tuple(float(q) for q in ladder_qmax))
        level_ptr, n_levels = level.data_ptr(), len(ladder_qmax)
    fn, slots = _fn("quant_pack_multi_f32"), _pack_slots(dev).data_ptr()
    for lo in range(0, len(table), 6 * MAX_LEAVES):
        chunk = array.array("q", table[lo:lo + 6 * MAX_LEAVES])
        build.launch("quant_pack_multi", fn, dev, chunk.buffer_info()[0],
                     len(chunk) // 6, bits, slots, level_ptr, ladder,
                     n_levels)
        quant_pack_cuda.launches += 2
    views = [v for v, leaf in zip(codes.split_with_sizes(split), keep)
             if leaf]
    return list(zip(views, scales.split(1)))


def quant_unpack_cuda(packed, scale, *, bits=8, n=None):
    """Launches K4 (the multi-leaf kernel with a one-leaf table): packed
    int8 [n] (bits 8) or uint8 [m >= n/2] (bits 4) and scale float32 [1],
    contiguous on one CUDA device -> float32 [n]."""
    _check_bits("quant_unpack_cuda", bits)
    dev = _cuda_device("quant_unpack_cuda", packed)
    _check("quant_unpack_cuda", "packed", packed, dev,
           torch.int8 if bits == 8 else torch.uint8)
    _check("quant_unpack_cuda", "scale", scale, dev, torch.float32, 1)
    n = _unpack_n(packed, bits, n)
    if n == 0:
        raise ValueError("quant_unpack_cuda: n must be positive")
    out = torch.empty(n, device=dev, dtype=torch.float32)
    q_ptr, out_ptr = packed.data_ptr(), out.data_ptr()
    _unpack_launch(dev, [q_ptr, scale.data_ptr(), out_ptr, n, bits,
                         q_ptr % 4 == 0 and out_ptr % 16 == 0])
    return out


quant_unpack_cuda.launches = 0


def quant_unpack_multi_cuda(packed, scales, *, bits=8, ns=None):
    """K4 over the leaves of a message, up to 64 leaves a launch: packed
    and scales are lists of :func:`quant_unpack_cuda`'s inputs on one CUDA
    device, ns their element counts (None: all the codes).  Returns one
    float32 [n] view per leaf of a single flat buffer (each leaf starts
    16-byte aligned).  Each launch adds one to ``quant_unpack_cuda``'s
    count."""
    _check_bits("quant_unpack_multi_cuda", bits)
    n_leaves = len(packed)
    if not n_leaves or len(scales) != n_leaves \
            or (ns is not None and len(ns) != n_leaves):
        raise ValueError(f"quant_unpack_multi_cuda: {n_leaves} code "
                         f"tensors, {len(scales)} scales and "
                         f"{None if ns is None else len(ns)} counts")
    dev = _cuda_device("quant_unpack_multi_cuda", packed[0])
    dtype = torch.int8 if bits == 8 else torch.uint8
    f32 = torch.float32
    # per leaf: codes, scale, output offset (filled in below), n, bits, vec
    table, split, keep, total = [], [], [], 0
    for i in range(n_leaves):
        q, s = packed[i], scales[i]
        if q.dtype != dtype or s.dtype != f32 or q.device != dev \
                or s.device != dev or q.dim() != 1 or s.numel() != 1 \
                or not q.is_contiguous():
            _check("quant_unpack_multi_cuda", f"packed[{i}]", q, dev, dtype)
            _check("quant_unpack_multi_cuda", f"scales[{i}]", s, dev, f32, 1)
        cap = q.numel() * (1 if bits == 8 else 2)
        n = cap if ns is None else ns[i]
        if not 0 < n <= cap:
            raise ValueError(f"quant_unpack_multi_cuda: n={n} outside [1, "
                             f"{cap}] for leaf {i} at {bits} bits")
        q_ptr = q.data_ptr()
        table += (q_ptr, s.data_ptr(), total, n, bits, q_ptr % 4 == 0)
        pad = -n % 4 if i + 1 < n_leaves else 0   # next leaf 16-byte aligned
        split += (n, pad) if pad else (n,)
        keep += (True, False) if pad else (True,)
        total += n + pad
    out = torch.empty(total, device=dev, dtype=f32)
    base = out.data_ptr()
    for j in range(2, len(table), 6):
        table[j] = base + 4 * table[j]
        table[j + 3] = table[j + 3] and base % 16 == 0
    _unpack_launch(dev, table)
    return [v for v, leaf in zip(out.split_with_sizes(split), keep) if leaf]


def _unpack_launch(dev, table):
    """K4 over a leaf table (six ints a leaf: codes, scale and output
    addresses, n, bits, vec), one launch per 64 leaves, each counted on
    ``quant_unpack_cuda``."""
    fn = _fn("quant_unpack_multi_f32")
    for lo in range(0, len(table), 6 * MAX_LEAVES):
        chunk = array.array("q", table[lo:lo + 6 * MAX_LEAVES])
        build.launch("quant_unpack", fn, dev, chunk.buffer_info()[0],
                len(chunk) // 6)
        quant_unpack_cuda.launches += 1


def topk_select_cuda(x, thresh):
    """Launches K5: x float32 [n] and thresh float32 [1], contiguous on one
    CUDA device -> float32 [n].  One combined test guards the launch; the
    detailed refusal is built only when it fails."""
    if not _topk_takes(x, thresh):
        _topk_refuse(x, thresh)
    out = torch.empty_like(x)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    build.launch("topk_select", _fn("topk_select_f32"), x.device, x_ptr,
                 thresh.data_ptr(), out_ptr, x.numel(),
                 not (x_ptr | out_ptr) & 15)
    topk_select_cuda.launches += 1
    return out


def _topk_takes(x, thresh):
    """True when K5 takes (x, thresh): a contiguous non-empty float32 [n]
    on a CUDA device and a float32 [1] on the same one."""
    return (x.is_cuda and x.dtype == _F32 and x.dim() == 1
            and x.is_contiguous() and x.numel() > 0
            and thresh.dtype == _F32 and thresh.dim() == 1
            and thresh.numel() == 1
            and thresh.get_device() == x.get_device())


def _topk_refuse(x, thresh):
    """Raises the ValueError that names what K5 does not take."""
    dev = _cuda_device("topk_select_cuda", x)
    _check("topk_select_cuda", "x", x, dev, torch.float32)
    _check("topk_select_cuda", "thresh", thresh, dev, torch.float32, 1)
    raise ValueError("topk_select_cuda: empty input")


def topk_schedule(n, *, vec=True, device=None):
    """K5's launch for n elements on a CUDA device, as ``topk_select_cuda``
    makes it (16-byte aligned x and out when ``vec``): threads a block,
    groups a thread (float4s when ``vec``, else floats), blocks, and the
    blocks of one full wave."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    sched = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        rc = _fn("topk_select_schedule")(n, int(vec), sched)
    if rc:
        raise ValueError(f"topk_schedule: n={n} (CUDA error {rc})")
    return dict(zip(("threads", "unroll", "blocks", "wave"), sched))


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
    build.launch("ef_gather", _fn("ef_gather_f32"), table.device,
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
    build.launch("ef_scatter", _fn("ef_scatter_f32"), table.device,
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            rows.data_ptr(), k, n, vec)
    ef_scatter_cuda.launches += 1
    # the write went through ctypes: tell autograd (and the analyzer's
    # in-place check) that the table changed, as index_copy_ would
    torch.autograd.graph.increment_version(table)
    return table


ef_scatter_cuda.launches = 0


# --------------------------------------------------------------------------
# dispatch: the plain version for CPU tensors only
# --------------------------------------------------------------------------

def _per_launch(n):
    """Launches of a multi-leaf kernel over ``n`` leaves (one per
    ``MAX_LEAVES``)."""
    return -(-n // MAX_LEAVES)


def _rows_launch(table, idx, *rest):
    """K6 / K7 launch nothing for zero rows or an empty row."""
    return int(idx.numel() > 0 and table.numel() > 0)


@kernel_entry("quant_pack")
def quant_pack(x, scale, noise, *, bits=8):
    """K3 on the card, its plain version for tensors on the CPU."""
    if runs_plain(x):
        return quant_pack_plain(x, scale, noise, bits=bits)
    return quant_pack_cuda(x, scale, noise, bits=bits)


@kernel_entry("quant_pack", lambda xs, *a, **k: {
    "quant_pack": 2 * _per_launch(len(xs))})
def quant_pack_multi(xs, noises, *, bits=8, level=None, ladder_qmax=None):
    """K3 over a message's leaves, scales included, in two launches (per 64
    leaves) on the card; the plain version leaf by leaf for tensors on the
    CPU.  ``level`` / ``ladder_qmax``: a ladder level (see
    :func:`quant_pack_multi_cuda`)."""
    if runs_plain(xs[0]):
        return quant_pack_multi_plain(xs, noises, bits=bits, level=level,
                                      ladder_qmax=ladder_qmax)
    return quant_pack_multi_cuda(xs, noises, bits=bits, level=level,
                                 ladder_qmax=ladder_qmax)


@kernel_entry("quant_unpack")
def quant_unpack(packed, scale, *, bits=8, n=None):
    """K4 on the card, its plain version for tensors on the CPU."""
    if runs_plain(packed):
        return quant_unpack_plain(packed, scale, bits=bits, n=n)
    return quant_unpack_cuda(packed, scale, bits=bits, n=n)


@kernel_entry("quant_unpack", lambda packed, *a, **k: {
    "quant_unpack": _per_launch(len(packed))})
def quant_unpack_multi(packed, scales, *, bits=8, ns=None):
    """K4 over a message's leaves in one launch (per 64 leaves) on the
    card, the plain version leaf by leaf for tensors on the CPU."""
    if runs_plain(packed[0]):
        return quant_unpack_multi_plain(packed, scales, bits=bits, ns=ns)
    return quant_unpack_multi_cuda(packed, scales, bits=bits, ns=ns)


@kernel_entry("topk_select")
def topk_select(x, thresh):
    """K5 on the card, its plain version for tensors on the CPU."""
    if runs_plain(x):
        return topk_select_plain(x, thresh)
    return topk_select_cuda(x, thresh)


@kernel_entry("ef_gather", lambda *a: {"ef_gather": _rows_launch(*a)})
def ef_gather(table, idx):
    """K6 on the card, its plain version for tensors on the CPU."""
    if runs_plain(table):
        return ef_gather_plain(table, idx)
    return ef_gather_cuda(table, idx)


@kernel_entry("ef_scatter", lambda *a: {"ef_scatter": _rows_launch(*a)})
def ef_scatter(table, idx, rows):
    """K7 on the card (in place), its plain version for tensors on the
    CPU; returns the table."""
    if runs_plain(table):
        return ef_scatter_plain(table, idx, rows)
    return ef_scatter_cuda(table, idx, rows)
