"""The plain version of K8b / K8c (``flash_bwd_plain``) and the CPU
backward of the port's ``FlashAttention`` against ``jax.vjp`` of the JAX
package's ``make_flash_attention`` (its Pallas forward and backward
kernels in interpret mode), on the same seeded numpy inputs.

Tolerance: float32 throughout.  The Pallas kernels sum dq over 16-key
blocks and dk / dv over 16-position blocks, the plain version in full
products over every key and row; the two orders agree to a few float32
ulps of the gradients' scale (|grad| up to ~10 here), held at rtol 1e-4 /
atol 1e-5.  The Pallas blocks are small (16) so that several of them, and
the masks of partial blocks, run; the lengths are ragged (not multiples
of 16), one shorter than two blocks.

K8c's schedule (``flash_attn.dkv_plan``: key tiles cut into segments of
query tiles, partial sums added in segment order, the visibility of each
tile) and K8b's (``flash_attn.dq_plan``: query tiles cut into segments of
key tiles, likewise) are emulated in plain PyTorch, tile by tile as the
kernels walk them, and held to ``jax.vjp`` at 1e-5 of each gradient's
largest element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import make_flash_attention as j_make_flash
from repro_torch.kernels import flash_attn

RTOL, ATOL = 1e-4, 1e-5

CASES = [                    # B, S, H, KV, hd, window
    (1, 33, 3, 1, 64, None),     # rep 3, ragged
    (2, 33, 4, 1, 64, 8),        # rep 4, window
    (1, 50, 4, 1, 256, 8),       # rep 4 (gemma3's), hd 256, window
    (1, 50, 3, 3, 256, None),    # rep 1, hd 256
    (1, 160, 2, 2, 64, 8),       # rep 1, window, ten blocks
    (1, 160, 6, 2, 64, None),    # rep 3, ten blocks
    (1, 33, 4, 4, 80, None),     # rep 1, hd 80 (stablelm-3b), ragged
    (1, 50, 8, 2, 120, 8),       # rep 4, hd 120 (h2o-danube-3-4b), window
]


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, window):
    flash = j_make_flash(causal=True, window=window, q_block=16,
                         kv_block=16, interpret=True)
    _, vjp = jax.vjp(flash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES)
def test_flash_bwd_plain_and_cpu_backward_match_pallas(B, S, H, KV, hd,
                                                       window):
    q, k, v, do = _inputs(B, S, H, KV, hd, seed=S + H + hd)
    want = _jax_grads(q, k, v, do, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attn.flash_fwd_plain(tq, tk, tv, window=window)
    _close(flash_attn.flash_bwd_plain(tq, tk, tv, o, lse, tdo,
                                      window=window), want)
    x = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attn.make_flash_attention(window=window)(*x)
    _close(torch.autograd.grad(out, x, tdo), want)


def test_flash_dcap_is_the_rowsum_in_lse_layout():
    rng = np.random.default_rng(0)
    do, o = (torch.from_numpy(rng.standard_normal((2, 5, 6, 8))
                              .astype(np.float32)) for _ in range(2))
    d = flash_attn.flash_dcap(do, o, KV=2)
    assert d.shape == (2, 2, 3, 5) and d.is_contiguous()
    # head g * rep + r of position p lands at [b, g, r, p]
    torch.testing.assert_close(d[1, 1, 2, 4], (do[1, 4, 5] * o[1, 4, 5]).sum())


def _dkv_emulated(q, k, v, do, lse, dcap, plan, causal, window):
    """dk, dv as K8c computes them under ``plan``: for each (b, g) and key
    tile, each segment's partial sums over its query tiles' (position,
    head) rows, visible pairs only, then the partials added in segment
    order."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    kt, positions = plan.key_tile, plan.positions
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for g in range(KV):
            heads = slice(g * rep, (g + 1) * rep)
            for j, k0 in enumerate(range(0, S, kt)):
                keys = torch.arange(k0, min(k0 + kt, S))
                kt_, vt = k[b, keys, g], v[b, keys, g]
                partials = []
                for t0, t1 in plan.segments(j):
                    acc_k = torch.zeros(len(keys), hd)
                    acc_v = torch.zeros(len(keys), hd)
                    for t in range(t0, t1):
                        q0 = t * positions
                        npos = min(positions, S - q0)
                        qt = q[b, q0:q0 + npos, heads].reshape(-1, hd)
                        dot = do[b, q0:q0 + npos, heads].reshape(-1, hd)
                        l_r = lse[b, g, :, q0:q0 + npos].T.reshape(-1)
                        d_r = dcap[b, g, :, q0:q0 + npos].T.reshape(-1)
                        pos = q0 + torch.arange(npos * rep) // rep
                        vis = torch.ones(len(pos), len(keys), dtype=bool)
                        if causal:
                            vis &= keys[None, :] <= pos[:, None]
                        if window is not None:
                            vis &= (pos[:, None] - keys[None, :]) < window
                        s = qt @ kt_.T * scale
                        p = torch.where(vis, torch.exp(s - l_r[:, None]),
                                        torch.zeros_like(s))
                        ds = p * (dot @ vt.T - d_r[:, None])
                        acc_v += p.T @ dot
                        acc_k += ds.T @ qt
                    partials.append((acc_k, acc_v))
                total_k, total_v = partials[0]
                for pk, pv in partials[1:]:
                    total_k, total_v = total_k + pk, total_v + pv
                dk[b, keys, g] = total_k * scale
                dv[b, keys, g] = total_v
    return dk, dv


DKV_CASES = [       # B, S, H, KV, hd, window, most segments a key tile
    (1, 100, 3, 1, 64, None, 3),     # rep 3, ragged
    (2, 70, 4, 1, 64, 8, 3),         # rep 4, window ends mid-tile
    (1, 50, 4, 1, 256, 8, 2),        # gemma3's rep, hd 256
    (1, 50, 4, 1, 256, None, 2),
    (1, 200, 2, 2, 64, 24, 1),       # rep 1, window: one segment each
    (1, 77, 6, 2, 128, None, 2),     # rep 3, hd 128
    (1, 20, 64, 1, 64, None, 10),    # rep 64: one position a tile
    (1, 150, 4, 4, 80, None, 2),     # rep 1, hd 80, ragged
    (1, 130, 8, 2, 120, 24, 3),      # rep 4, hd 120, window
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,max_ns", DKV_CASES)
def test_dkv_schedule_emulation_matches_pallas(B, S, H, KV, hd, window,
                                               max_ns):
    q, k, v, do = _inputs(B, S, H, KV, hd, seed=S + 7 * H + hd)
    want = _jax_grads(q, k, v, do, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attn.flash_fwd_plain(tq, tk, tv, window=window)
    dcap = flash_attn.flash_dcap(tdo, o, KV)
    plan = flash_attn.dkv_plan(B, S, H, KV, hd, True, window)
    # every key tile has at least one segment, and the case has the
    # segments it names
    assert min(plan.n_tiles) >= 1 and plan.max_ns == max_ns
    got = _dkv_emulated(tq, tk, tv, tdo, lse, dcap, plan, True, window)
    for g, w in zip(got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _visible_tiles(S, rep, window, plan, j):
    """Query tiles holding a position that sees a key of key tile j."""
    kt, positions = plan.key_tile, plan.positions
    keys = np.arange(j * kt, min((j + 1) * kt, S))
    tiles = set()
    for p in range(S):
        d = p - keys
        if np.any((d >= 0) & ((window is None) | (d < (window or 1)))):
            tiles.add(p // positions)
    return tiles


@pytest.mark.parametrize("S,H,KV,hd,window", [
    (1024, 4, 1, 256, None), (1024, 4, 1, 256, 512), (1024, 9, 3, 64, None),
    (1000, 8, 2, 128, None), (1000, 4, 1, 256, 512), (37, 64, 1, 64, 5),
    (1024, 32, 32, 80, None), (1024, 32, 8, 120, None),
    (4608, 32, 8, 120, 4096)])
def test_dkv_plan_covers_exactly_the_visible_tiles(S, H, KV, hd, window):
    """Each key tile's segments tile [t_lo, t_hi] without gap or overlap,
    that range is exactly the query tiles that see the key tile, and the
    default segment length splits gemma3-1b's long causal key tiles."""
    plan = flash_attn.dkv_plan(4, S, H, KV, hd, True, window)
    for j in range(len(plan.n_tiles)):
        segs = plan.segments(j)
        covered = [t for a, e in segs for t in range(a, e)]
        assert covered == sorted(set(covered))
        assert all(e - a <= plan.seg for a, e in segs)
        assert set(covered) == _visible_tiles(S, H // KV, window, plan, j)
    assert plan.max_ns == max(-(-n // plan.seg) for n in plan.n_tiles)
    if (S, window, hd) == (1024, None, 256):
        assert plan.max_ns > 1


def _dq_emulated(q, k, v, do, lse, dcap, plan, causal, window):
    """dq as K8b computes it under ``plan``: for each (b, g) and query
    tile, each segment's partial sum over its key tiles, visible pairs
    only, then the partials added in segment order."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    kt, positions = plan.key_tile, plan.positions
    dq = torch.zeros_like(q)
    for b in range(B):
        for g in range(KV):
            heads = slice(g * rep, (g + 1) * rep)
            for t, q0 in enumerate(range(0, S, positions)):
                npos = min(positions, S - q0)
                qt = q[b, q0:q0 + npos, heads].reshape(-1, hd)
                dot = do[b, q0:q0 + npos, heads].reshape(-1, hd)
                l_r = lse[b, g, :, q0:q0 + npos].T.reshape(-1)
                d_r = dcap[b, g, :, q0:q0 + npos].T.reshape(-1)
                pos = q0 + torch.arange(npos * rep) // rep
                partials = []
                for j0, j1 in plan.segments(t):
                    acc = torch.zeros(npos * rep, hd)
                    for j in range(j0, j1):
                        keys = torch.arange(j * kt, min((j + 1) * kt, S))
                        vis = torch.ones(len(pos), len(keys), dtype=bool)
                        if causal:
                            vis &= keys[None, :] <= pos[:, None]
                        if window is not None:
                            vis &= (pos[:, None] - keys[None, :]) < window
                        kj, vj = k[b, keys, g], v[b, keys, g]
                        s = qt @ kj.T * scale
                        p = torch.where(vis, torch.exp(s - l_r[:, None]),
                                        torch.zeros_like(s))
                        acc += p * (dot @ vj.T - d_r[:, None]) @ kj
                    partials.append(acc)
                total = partials[0]
                for part in partials[1:]:
                    total = total + part
                dq[b, q0:q0 + npos, heads] = (total * scale).reshape(
                    npos, rep, hd)
    return dq


DQ_CASES = [        # B, S, H, KV, hd, window, most segments a query tile
    (1, 100, 3, 1, 64, None, 2),     # rep 3, ragged: 2 key tiles at most
    (2, 150, 4, 1, 64, None, 3),     # rep 4: a tile sees up to 3 key tiles
    (1, 70, 4, 1, 256, 8, 2),        # gemma3's rep, hd 256, window
    (1, 100, 4, 1, 256, None, 4),    # hd 256: 32-key tiles, up to 4 a tile
    (1, 200, 2, 2, 64, 24, 2),       # rep 1, window ends mid-tile
    (1, 150, 6, 2, 128, None, 3),    # rep 3, hd 128: segments of 2 tiles
    (1, 20, 64, 1, 64, None, 1),     # rep 64: one position a tile
    (1, 200, 4, 4, 80, 24, 3),       # rep 1, hd 80: 32-key tiles, window
    (1, 100, 8, 2, 120, None, 4),    # rep 4, hd 120, ragged
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,max_ns", DQ_CASES)
def test_dq_schedule_emulation_matches_pallas(B, S, H, KV, hd, window,
                                              max_ns):
    q, k, v, do = _inputs(B, S, H, KV, hd, seed=S + 5 * H + hd)
    want = _jax_grads(q, k, v, do, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attn.flash_fwd_plain(tq, tk, tv, window=window)
    dcap = flash_attn.flash_dcap(tdo, o, KV)
    plan = flash_attn.dq_plan(B, S, H, KV, hd, True, window)
    # every query tile sees a key tile, and the case has the segments it
    # names
    assert min(plan.n_tiles) >= 1 and plan.max_ns == max_ns
    got = _dq_emulated(tq, tk, tv, tdo, lse, dcap, plan, True, window)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0,
                               atol=1e-5 * np.abs(want[0]).max())


def _visible_key_tiles(S, rep, window, plan, t):
    """Key tiles holding a key that a position of query tile t sees."""
    kt, positions = plan.key_tile, plan.positions
    pos = np.arange(t * positions, min((t + 1) * positions, S))
    keys = np.arange(S)
    d = pos[:, None] - keys[None, :]
    seen = np.any((d >= 0) & ((window is None) | (d < (window or 1))), 0)
    return set((keys[seen] // kt).tolist())


@pytest.mark.parametrize("S,H,KV,hd,window", [
    (1024, 4, 1, 256, None), (1024, 4, 1, 256, 512), (1024, 9, 3, 64, None),
    (1000, 8, 2, 128, None), (1000, 4, 1, 256, 512), (37, 64, 1, 64, 5),
    (1024, 32, 32, 80, None), (1024, 32, 8, 120, None),
    (4608, 32, 8, 120, 4096)])
def test_dq_plan_covers_exactly_the_visible_tiles(S, H, KV, hd, window):
    """Each query tile's segments tile its key range without gap or
    overlap, that range is exactly the key tiles its positions see, and
    the segment length splits gemma3-1b's local layer (its last wave would
    be ragged) and leaves its global layer and smollm-135m's whole (the
    longest units go first there and the rest fill in behind them)."""
    plan = flash_attn.dq_plan(4, S, H, KV, hd, True, window)
    assert len(plan.n_tiles) == -(-S // plan.positions)
    for t in range(len(plan.n_tiles)):
        segs = plan.segments(t)
        covered = [j for a, e in segs for j in range(a, e)]
        assert covered == sorted(set(covered))
        assert all(e - a <= plan.seg for a, e in segs)
        assert set(covered) == _visible_key_tiles(S, H // KV, window, plan,
                                                  t)
    assert plan.max_ns == max(-(-n // plan.seg) for n in plan.n_tiles)
    assert plan.units(4, KV) <= plan.max_ns * 4 * KV * len(plan.n_tiles)
    if (S, hd) == (1024, 256) or (S, hd) == (1024, 64):
        assert (plan.max_ns > 1) == (window is not None)
