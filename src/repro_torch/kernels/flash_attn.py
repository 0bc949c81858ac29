"""GQA flash attention forward, K8a (port of ``repro/kernels/flash_attn.py``
``flash_fwd`` and ``make_flash_attention``).

``flash_fwd(q, k, v)`` returns ``(o, lse)``: q [B,S,H,hd], k/v [B,S,KV,hd]
with H = KV * rep -> o [B,S,H,hd], lse [B,KV,rep,S] float32 (the JAX
layout pads lse to whole Pallas blocks; here it has exactly S columns).
Causal and sliding-window masks come from position arithmetic.  Tensors on
the card run the CUDA kernel ``csrc/flash_attn.cu``; tensors on the CPU run
:func:`flash_fwd_plain`, a masked full softmax in float32.  The kernel's
dispatch order (query tiles from the heaviest, every (b, g) group's tile of
one rank before the next rank) is :func:`fwd_plan`'s, which also models its
time on the card's block slots.

``flash_bwd(q, k, v, o, lse, do)`` returns ``(dq, dk, dv)``: tensors on
the card run K8b (``dq``) and K8c (``dk``, ``dv``) of
``csrc/flash_attn_bwd.cu`` after ``D = rowsum(do * o)`` in float32 (laid
out like lse, computed outside the kernels as the JAX package does);
tensors on the CPU run :func:`flash_bwd_plain`, the same formulas over
the full masked matrices in float32.  K8b's work units (a query tile and
a segment of the key tiles it sees) come from :func:`dq_plan`, K8c's (a
key tile and a segment of the query tiles that see it) from
:func:`dkv_plan`.

``make_flash_attention`` returns ``flash(q, k, v) -> o`` as a
``torch.autograd.Function`` whose forward is K8a and whose backward is K8b
and K8c (on the card; the plain versions on the CPU).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the head dims the kernels are built for: every one the repository's
# configs use (gemma3-1b 256, smollm-135m 64, stablelm-3b 80,
# h2o-danube-3-4b 120, and 128); any other is refused
HEAD_DIMS = (64, 80, 120, 128, 256)
MAX_REP = 64        # query heads per KV head: the kernel's 64-row tile
# keys a K8c work unit owns, and keys a K8b tile holds, by head dim
# (csrc/flash_attn_bwd.cu DkvTile, DqTile); keys a K8a tile holds
# (csrc/flash_attn.cu FwdTile)
DKV_KEYS = {64: 64, 80: 64, 120: 64, 128: 64, 256: 32}
DQ_KEYS = {64: 64, 80: 32, 120: 32, 128: 32, 256: 32}
FWD_KEYS = {64: 64, 80: 64, 120: 32, 128: 32, 256: 64}
# the width the kernels' output register tiles cover in shared memory (the
# next one whose float4 column groups divide the threads; the columns past
# hd are never stored): csrc Tile / FwdTile's HP
PADDED_HD = {80: 96, 120: 128}
_SMEM_PER_SM = 232448   # bytes of shared memory an H100 SM gives its blocks


def padded_hd(hd):
    """The kernels' row width in shared memory for head dim ``hd``."""
    return PADDED_HD.get(hd, hd)


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


def causal_mask(S, *, causal=True, window=None, device=None):
    """[S, S] bool, True where key k is visible from query p: k <= p
    (causal) and p - k < window."""
    pos = torch.arange(S, device=device)
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def flash_fwd_plain(q, k, v, *, causal=True, window=None):
    """(o, lse) in plain PyTorch: the masked full softmax in float32."""
    mask = causal_mask(q.shape[1], causal=causal, window=window,
                       device=q.device)
    return masked_softmax_attention(q, k, v, mask)


def flash_dcap(do, o, KV):
    """D = rowsum(do * o) in float32, laid out like lse: do, o [B,S,H,hd]
    with H = KV * rep -> [B,KV,rep,S]."""
    B, S, H, _ = do.shape
    d = (do.float() * o.float()).sum(-1)
    return d.reshape(B, S, KV, H // KV).permute(0, 2, 3, 1).contiguous()


def flash_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=None):
    """(dq, dk, dv) in plain PyTorch from the full masked matrices in
    float32, with the formulas of the JAX kernels: p = exp(s - lse),
    ds = p (do v^T - D), dq = ds k * scale, dk = ds^T q * scale summed over
    the rep heads of a group, dv = p^T do likewise."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    mask = causal_mask(S, causal=causal, window=window, device=q.device)
    qh = q.reshape(B, S, KV, rep, hd).float()
    doh = do.reshape(B, S, KV, rep, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh, kf) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqgrd,bkgd->bgrqk", doh, vf)
    ds = p * (dp - flash_dcap(do, o, KV)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qh) * scale
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, doh)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@dataclasses.dataclass(frozen=True)
class DkvPlan:
    """K8c's schedule for one shape.  Key tile j (keys j * key_tile ..) is
    seen by the query tiles t_lo .. t_hi of ``positions`` positions each
    (``rows`` (position, head) rows); ``n_tiles[j]`` counts them.  Its
    segments are the runs of at most ``seg`` of those tiles from t_lo on,
    ``ceil(n_tiles[j] / seg)`` of them; ``max_ns`` is the most any key tile
    has.  The kernel launches ``max_ns * B * KV * len(n_tiles)`` units and
    the ones past their key tile's segments exit at once."""
    key_tile: int
    rows: int
    positions: int
    seg: int
    max_ns: int
    t_lo: tuple
    n_tiles: tuple

    def segments(self, j):
        """(first, end) query tiles of key tile j's segments, in order."""
        lo, n = self.t_lo[j], self.n_tiles[j]
        return [(lo + a, lo + min(a + self.seg, n))
                for a in range(0, n, self.seg)]

    def scratch_floats(self, B, KV, hd):
        """Floats of partial sums the launch needs (0: none)."""
        if self.max_ns == 1:
            return 0
        return (B * KV * len(self.n_tiles) * self.max_ns * 2
                * self.key_tile * hd)


def _dkv_blocks_per_sm(hd, key_tile, rows):
    """K8c blocks an SM holds: two where shared memory admits them (the
    kernel's __launch_bounds__ asks the registers for the same)."""
    rs, ps = padded_hd(hd) + 4, key_tile + 4
    floats = 2 * key_tile * rs + 2 * rows * rs + 2 * rows + 2 * rows * ps
    return 2 if 2 * (4 * floats + 1024) <= _SMEM_PER_SM else 1


@functools.lru_cache(maxsize=256)
def dkv_plan(B, S, H, KV, hd, causal=True, window=None, *, n_sm=132):
    """K8c's :class:`DkvPlan` for q [B,S,H,hd], k/v [B,S,KV,hd] on a card
    of ``n_sm`` SMs.  The segment length is a quarter of the tiles each of
    the card's block slots would walk under a perfect balance (at least
    2), so that the longest unit is short beside a slot's share; a key
    tile shorter than that stays whole."""
    kt = DKV_KEYS[hd]
    rows = 64
    positions = rows // (H // KV)
    t_lo, n_tiles = [], []
    for k0 in range(0, S, kt):
        p_lo = k0 if causal else 0
        p_hi = S - 1 if window is None else min(S - 1, k0 + kt + window - 2)
        t_lo.append(p_lo // positions)
        n_tiles.append(p_hi // positions - p_lo // positions + 1)
    longest = max(n_tiles)
    slots = n_sm * _dkv_blocks_per_sm(hd, kt, rows)
    seg = min(max(2, math.ceil(B * KV * sum(n_tiles) / slots / 4)), longest)
    max_ns = -(-longest // seg)
    return DkvPlan(kt, rows, positions, seg, max_ns, tuple(t_lo),
                   tuple(n_tiles))


@dataclasses.dataclass(frozen=True)
class DqPlan:
    """K8b's schedule for one shape.  Query tile t (``positions``
    positions from t * positions, ``rows`` (position, head) rows) sees the
    key tiles j_lo[t] .. of ``key_tile`` keys each; ``n_tiles[t]`` counts
    them.  Its segments are the runs of at most ``seg`` of those key tiles
    from j_lo on, ``ceil(n_tiles[t] / seg)`` of them; ``max_ns`` is the
    most any query tile has.  The kernel launches ``max_ns * B * KV *
    len(n_tiles)`` units, segment slowest, then the query tile from the
    last to the first (heavy first under a causal mask), then the (b, g)
    group; the ones past their query tile's segments exit at once."""
    key_tile: int
    rows: int
    positions: int
    seg: int
    max_ns: int
    j_lo: tuple
    n_tiles: tuple

    def segments(self, t):
        """(first, end) key tiles of query tile t's segments, in order."""
        lo, n = self.j_lo[t], self.n_tiles[t]
        return [(lo + a, lo + min(a + self.seg, n))
                for a in range(0, n, self.seg)]

    def units(self, B, KV):
        """Work units that do work (the launch has max_ns * B * KV *
        len(n_tiles))."""
        return B * KV * sum(-(-n // self.seg) for n in self.n_tiles)

    def scratch_floats(self, B, KV, hd):
        """Floats of partial sums the launch needs (0: none)."""
        if self.max_ns == 1:
            return 0
        return B * KV * len(self.n_tiles) * self.max_ns * self.rows * hd


def _dq_blocks_per_sm(hd, key_tile, rows):
    """K8b blocks an SM holds: two where shared memory admits them (the
    kernel's __launch_bounds__ asks the registers for the same)."""
    rs = padded_hd(hd) + 4
    floats = 2 * rows * rs + 2 * key_tile * rs + key_tile * (rows + 4) \
        + 2 * rows
    return 2 if 2 * (4 * floats + 1024) <= _SMEM_PER_SM else 1


def _slot_makespan(costs, slots):
    """When the last of ``costs`` (in launch order) ends if the card's
    ``slots`` block slots take them in that order, each the moment a slot
    is free."""
    free = [0.0] * slots
    for cost in costs:
        heapq.heapreplace(free, free[0] + cost)
    return max(free)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """K8a's schedule for one shape.  Query tile t (``positions``
    positions from t * positions) sees ``n_tiles[t]`` key tiles of
    ``key_tile`` keys.  The launch has ``len(n_tiles) * groups`` blocks in
    the order :meth:`costs` lists them: tile rank slowest (the last tile
    first), the (b, g) group fastest.  ``makespan`` is the time in key-tile
    steps until the last block ends on ``slots`` block slots (a block
    costs its key tiles and one more for its query tile), ``ideal`` the
    total cost over the slots."""
    key_tile: int
    positions: int
    groups: int
    slots: int
    n_tiles: tuple

    def costs(self):
        return [n + 1 for n in reversed(self.n_tiles)
                for _ in range(self.groups)]

    @property
    def makespan(self):
        return _slot_makespan(self.costs(), self.slots)

    @property
    def ideal(self):
        return sum(self.costs()) / self.slots


def _fwd_blocks_per_sm(hd, key_tile, rows=64):
    """K8a blocks an SM holds: as many as shared memory admits, at most
    two (csrc/flash_attn.cu FwdTile)."""
    rs = padded_hd(hd) + 4
    floats = rows * rs + 2 * key_tile * rs + key_tile * (rows + 4) + rows
    return min(2, _SMEM_PER_SM // (4 * floats + 1024))


@functools.lru_cache(maxsize=256)
def fwd_plan(B, S, H, KV, hd, causal=True, window=None, *, n_sm=132):
    """K8a's :class:`FwdPlan` for q [B,S,H,hd], k/v [B,S,KV,hd] on a card
    of ``n_sm`` SMs."""
    kt = FWD_KEYS[hd]
    positions = 64 // (H // KV)
    n_tiles = []
    for q0 in range(0, S, positions):
        k_lo = 0 if window is None else max(0, q0 - window + 1)
        k_hi = min(S, q0 + positions) - 1 if causal else S - 1
        n_tiles.append(k_hi // kt - k_lo // kt + 1)
    return FwdPlan(kt, positions, B * KV, n_sm * _fwd_blocks_per_sm(hd, kt),
                   tuple(n_tiles))


def _dq_makespan(n_tiles, seg, groups, slots):
    """Key-tile steps until K8b's last unit ends when the card's ``slots``
    block slots take the units in launch order, each the moment a slot
    is free.  A unit costs its key tiles, one more for loading its query
    tile, and half one more when its query tile is split (the partial
    sum's write and read)."""
    costs = [min(seg, n - sg * seg) + 1 + (0.5 if n > seg else 0)
             for sg in range(-(-max(n_tiles) // seg))
             for n in reversed(n_tiles) if sg * seg < n
             for _ in range(groups)]
    return _slot_makespan(costs, slots)


@functools.lru_cache(maxsize=256)
def dq_plan(B, S, H, KV, hd, causal=True, window=None, *, n_sm=132):
    """K8b's :class:`DqPlan` for q [B,S,H,hd], k/v [B,S,KV,hd] on a card
    of ``n_sm`` SMs.  The segment length is the longest query tile's key
    tiles cut in 1, 2, 3 or 4, whichever :func:`_dq_makespan` finds
    ends soonest (ties to the longer segment): splitting pays only where
    the last wave would be ragged, as at gemma3-1b's local layer, where
    every unit of the first wave ends together and the second wave's
    longest units start only then."""
    kt = DQ_KEYS[hd]
    rows = 64
    positions = rows // (H // KV)
    j_lo, n_tiles = [], []
    for q0 in range(0, S, positions):
        k_lo = 0 if window is None else max(0, q0 - window + 1)
        k_hi = min(S, q0 + positions) - 1 if causal else S - 1
        j_lo.append(k_lo // kt)
        n_tiles.append(k_hi // kt - k_lo // kt + 1)
    longest = max(n_tiles)
    slots = n_sm * _dq_blocks_per_sm(hd, kt, rows)
    seg = min(dict.fromkeys(-(-longest // d) for d in (1, 2, 3, 4)),
              key=lambda g: (_dq_makespan(n_tiles, g, B * KV, slots), -g))
    max_ns = -(-longest // seg)
    return DqPlan(kt, rows, positions, seg, max_ns, tuple(j_lo),
                  tuple(n_tiles))


def _check(fn, window, **tensors):
    """The kernels' contract, raised as ValueError: contiguous 16-byte
    aligned float32 on one CUDA device; q (and do) [B,S,H,hd], k / v
    [B,S,KV,hd] with hd in ``HEAD_DIMS`` (64, 80, 120, 128, 256) and
    1 <= H/KV <= 64; lse (and D) [B,KV,H/KV,S].  Returns (B, S, H, KV,
    hd)."""
    q = tensors["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {q.device}")
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 4:
            raise ValueError(
                f"{fn}: {name} must be a contiguous 4-d float32 "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    B, S, H, hd = q.shape
    k = tensors["k"]
    KV = k.shape[2]
    heads_ok = KV >= 1 and H % KV == 0 and 1 <= H // KV <= MAX_REP
    want = {"q": (B, S, H, hd), "do": (B, S, H, hd), "k": (B, S, KV, hd),
            "v": (B, S, KV, hd)}
    if heads_ok:
        want["lse"] = want["dcap"] = (B, KV, H // KV, S)
    if not heads_ok or hd not in HEAD_DIMS or S < 1 or B < 1 \
            or any(tuple(t.shape) != want.get(n) for n, t in tensors.items()):
        raise ValueError(
            f"{fn}: shapes " + ", ".join(f"{n} {tuple(t.shape)}"
                                         for n, t in tensors.items())
            + f" (want q [B,S,KV*rep,hd], k/v [B,S,KV,hd], lse [B,KV,rep,S] "
            f"with hd in {HEAD_DIMS} and 1 <= rep <= {MAX_REP}; hd={hd}"
            + ("" if hd in HEAD_DIMS else ": no kernel is built for it")
            + ")")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{fn}: {tuple(q.shape)} too large")
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError(f"{fn}: every tensor must start 16-byte aligned "
                         "(the kernels read float4s); pass a copy")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window={window!r} must be >= 1")
    return B, S, H, KV, hd


@functools.cache
def _kernel(name):
    lib = build.load("flash_attn_bwd" if name.startswith("flash_bwd")
                     else "flash_attn")
    fn = getattr(lib, name)
    n_ptrs = {"flash_fwd_f32": 5, "flash_bwd_dq_f32": 9,
              "flash_bwd_dkv_f32": 10}[name]
    # K8b and K8c also take their schedule (seg, max_ns)
    n_plan = 0 if name == "flash_fwd_f32" else 2
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * n_plan
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _scratch(floats, n_tickets, device):
    """(partials pointer, tickets pointer, buffer) for a split schedule:
    ``floats`` float32 partial sums, then ``n_tickets`` int32 tickets (the
    launch zeroes them); (None, None, None) when nothing is split.  The
    caller keeps the buffer alive until the launch is queued."""
    if not floats:
        return None, None, None
    scratch = torch.empty(floats + n_tickets, dtype=torch.float32,
                          device=device)
    part = scratch.data_ptr()
    return part, part + 4 * floats, scratch


def _launch(name, tensors, dims, causal, window, ptrs=(), plan=()):
    """``name``(tensors' pointers, ptrs, dims, causal, window, scale, plan,
    stream) on the tensors' device and its current stream."""
    build.launch(name, _kernel(name), tensors[0].device,
                 *(t.data_ptr() for t in tensors), *ptrs, *dims, int(causal),
                 0 if window is None else int(window),
                 float(dims[-1] ** -0.5), *plan)


def flash_fwd_cuda(q, k, v, *, causal=True, window=None):
    """Launches K8a (``csrc/flash_attn.cu``): q [B,S,H,hd], k/v
    [B,S,KV,hd], contiguous 16-byte aligned float32 on one CUDA device, hd
    in ``HEAD_DIMS``, 1 <= H/KV <= 64 -> (o [B,S,H,hd], lse
    [B,KV,H/KV,S])."""
    B, S, H, KV, hd = _check("flash_fwd_cuda", window, q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((B, KV, H // KV, S), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd_f32", (q, k, v, o, lse), (B, S, H, KV, hd), causal,
            window)
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, dcap, *, causal=True, window=None):
    """Launches K8b (``csrc/flash_attn_bwd.cu``): q, do [B,S,H,hd], k/v
    [B,S,KV,hd], lse and D = rowsum(do * o) [B,KV,H/KV,S], under K8a's
    contract -> dq [B,S,H,hd], scheduled by :func:`dq_plan`."""
    dims = _check("flash_bwd_dq_cuda", window, q=q, k=k, v=v, do=do,
                  lse=lse, dcap=dcap)
    B, S, H, KV, hd = dims
    plan = dq_plan(B, S, H, KV, hd, bool(causal), window,
                   n_sm=build.sm_count(q.device.index))
    dq = torch.empty_like(q)
    part, tickets, scratch = _scratch(plan.scratch_floats(B, KV, hd),
                                      B * KV * len(plan.n_tiles), q.device)
    _launch("flash_bwd_dq_f32", (q, k, v, do, lse, dcap, dq), dims, causal,
            window, ptrs=(part, tickets), plan=(plan.seg, plan.max_ns))
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, *, causal=True, window=None):
    """Launches K8c (``csrc/flash_attn_bwd.cu``): the inputs of
    :func:`flash_bwd_dq_cuda` -> (dk, dv) [B,S,KV,hd], scheduled by
    :func:`dkv_plan`."""
    dims = _check("flash_bwd_dkv_cuda", window, q=q, k=k, v=v, do=do,
                  lse=lse, dcap=dcap)
    B, S, H, KV, hd = dims
    plan = dkv_plan(B, S, H, KV, hd, bool(causal), window,
                    n_sm=build.sm_count(q.device.index))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part, tickets, scratch = _scratch(plan.scratch_floats(B, KV, hd),
                                      B * KV * len(plan.n_tiles), q.device)
    _launch("flash_bwd_dkv_f32", (q, k, v, do, lse, dcap, dk, dv), dims,
            causal, window, ptrs=(part, tickets),
            plan=(plan.seg, plan.max_ns))
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_fwd(q, k, v, *, causal=True, window=None):
    """(o, lse) with scale hd^-0.5: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    return flash_fwd_cuda(q, k, v, causal=causal, window=window)


def flash_bwd(q, k, v, o, lse, do, *, causal=True, window=None):
    """(dq, dk, dv): K8b and K8c for tensors on the card, the plain
    version for tensors on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                               window=window)
    dcap = flash_dcap(do, o, k.shape[2])
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, dcap, causal=causal,
                           window=window)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, causal=causal,
                                window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def make_flash_attention(*, causal=True, window=None):
    """Returns flash(q, k, v) -> o: K8a forward, K8b / K8c backward.

    q [B,S,H,hd]; k,v [B,S,KV,hd] with H = KV*rep.
    """
    def flash(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)

    return flash
