"""The plain versions of K8a (flash attention forward) and K9 (flash-decode)
against the JAX Pallas kernels in interpret mode, and the port's plain
attention functions against the JAX package's, on the same seeded numpy
inputs.  K8a's tile walk (``flash_attn.fwd_plan``: key tiles per query
tile, per-element masks only on the tiles that cross the diagonal, the
window's edge or S) is emulated in plain PyTorch and held to the Pallas
kernel, and its dispatch order is checked against the parent's.

Tolerance: float32 throughout.  The Pallas kernels sum each row's
softmax in blocks with online rescaling, the plain versions in one full
softmax; the two orders agree to a few float32 ulps of the output's scale,
held at atol 1e-5 / rtol 1e-4 (o, lse and the decode output alike).  The
Pallas blocks are small here (16 positions) so several of them, and their
rescaling, run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attn import flash_decode as j_flash_decode
from repro.kernels.flash_attn import flash_fwd as j_flash_fwd
from repro.models import attention as jattn
from repro_torch.kernels import decode_attn, flash_attn, ops, ref
from repro_torch.models import attention as tattn

ATOL, RTOL = 1e-5, 1e-4


def _qkv(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", [
    (2, 64, 4, 1, 64, None, True),      # rep 4 (gemma3's), whole blocks
    (1, 50, 6, 2, 64, 16, True),        # rep 3, window, ragged S
    (1, 40, 2, 2, 256, None, True),     # rep 1, hd 256, ragged S
    (1, 33, 4, 1, 256, 8, True),        # rep 4, hd 256, window, ragged S
    (1, 24, 3, 1, 64, None, False),     # rep 3, bidirectional
    (1, 50, 4, 4, 80, None, True),      # rep 1, hd 80 (stablelm-3b), ragged
    (1, 40, 8, 2, 120, 16, True),       # rep 4, hd 120 (h2o-danube-3-4b),
])                                      # window, ragged
def test_flash_fwd_plain_matches_pallas(B, S, H, KV, hd, window, causal):
    q, k, v = _qkv(B, S, S, H, KV, hd, seed=S + H + hd)
    o_j, lse_j = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=hd ** -0.5, causal=causal, window=window,
                             q_block=16, kv_block=16, interpret=True)
    o, lse = flash_attn.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    assert tuple(lse.shape) == (B, KV, H // KV, S)
    _close(o, o_j)
    _close(lse, np.asarray(lse_j)[..., :S])
    # the oracle in kernels/ref.py is the same plain version
    o_ref, lse_ref = ref.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=window)
    assert torch.equal(o_ref, o) and torch.equal(lse_ref, lse)


@pytest.mark.parametrize("B,L,H,KV,hd", [(2, 40, 4, 1, 64),
                                         (1, 24, 6, 2, 256),
                                         (3, 48, 3, 3, 64),
                                         (2, 40, 4, 4, 80),     # rep 1
                                         (1, 48, 8, 2, 120)])   # rep 4
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_flash_decode_plain_matches_pallas(B, L, H, KV, hd, frac):
    q, k, v = _qkv(B, 1, L, H, KV, hd, seed=L + H)
    valid = max(1, int(frac * L))
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          valid, block_l=16, interpret=True)
    want_ref = jref.decode_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), valid)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (decode_attn.flash_decode(tq, tk, tv, valid),
                decode_attn.flash_decode(tq, tk, tv, torch.tensor(valid)),
                ops.gqa_flash_decode(tq, tk, tv, valid),
                ref.decode_attn_ref(tq, tk, tv, valid)):
        _close(got, want)
        _close(got, want_ref)


@pytest.mark.parametrize("valid", [1, 40, 131, 256])
def test_flash_decode_plain_rep16_matches_pallas(valid):
    """recurrentgemma-9b's heads (16 query heads over one KV head of 256):
    the plain version against the Pallas kernel in interpret mode."""
    q, k, v = _qkv(1, 1, 256, 16, 1, 256, seed=valid)
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          valid, block_l=64, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(decode_attn.flash_decode(tq, tk, tv, valid), want)
    _close(ops.gqa_flash_decode(tq, tk, tv, torch.tensor(valid)), want)


# (B, L, KV, rep, hd): the serve shapes (gemma3-1b global and local,
# smollm-135m, recurrentgemma-9b's rep 16), a one-position cache, a long
# cache, many groups, hd 128, and the serve shapes of stablelm-3b (hd 80)
# and h2o-danube-3-4b (hd 120: its full ring and a cache of 1,056)
PLAN_CASES = [(4, 1056, 1, 4, 256), (4, 512, 1, 4, 256), (4, 1056, 3, 3, 64),
              (4, 1056, 1, 16, 256), (1, 1, 1, 1, 64), (1, 131072, 8, 4, 128),
              (512, 100, 64, 2, 64), (2, 33, 2, 5, 128),
              (4, 1056, 32, 1, 80), (1, 4096, 8, 4, 120),
              (1, 1056, 8, 4, 120)]


@pytest.mark.parametrize("sm_count", [132, 1])
@pytest.mark.parametrize("B,L,KV,rep,hd", PLAN_CASES)
def test_decode_plan_covers_the_cache_once(B, L, KV, rep, hd, sm_count):
    """K9's slices: every cache position in exactly one slice, the grid and
    the shared memory within the card's limits, each block staging at least
    32 KB where L allows and at most 64 KB, and no more blocks than fill
    the card once unless the 64 KB cap forces them."""
    plan = decode_attn.decode_plan(B, L, KV, rep, hd, sm_count)
    starts = [s * plan.split for s in range(plan.n_split)]
    covered = np.zeros(L, np.int64)
    for s0 in starts:
        covered[s0:s0 + plan.split] += 1
    assert (covered == 1).all() and starts[-1] < L
    assert plan.groups == B * KV <= decode_attn.MAX_GROUPS
    assert 1 <= plan.n_split < 2 ** 31 and 1 <= plan.split <= L
    assert plan.smem_bytes == 4 * (2 * plan.split * hd + rep * plan.split
                                   + 2 * rep) <= decode_attn.SMEM_LIMIT
    row = 8 * hd
    assert plan.split * row <= decode_attn.MAX_SLICE_BYTES
    assert (plan.split * row >= decode_attn.MIN_SLICE_BYTES
            or plan.split == L)
    fill = decode_attn.BLOCKS_PER_SM * sm_count
    assert (plan.groups * (plan.n_split - 1) < fill
            or plan.split == decode_attn.MAX_SLICE_BYTES // row)


def test_decode_plan_refuses_what_the_kernel_cannot_take():
    # the kernel is built for the configs' head dims (80 and 120 since
    # they were added: 32 KB of 640-byte K + V rows a slice); 96 is none
    assert decode_attn.decode_plan(1, 64, 1, 1, 80, 132).split == 52
    with pytest.raises(ValueError, match="hd"):
        decode_attn.decode_plan(1, 64, 1, 1, 96, 132)
    with pytest.raises(ValueError, match="B \\* KV"):
        decode_attn.decode_plan(65536, 64, 1, 1, 64, 132)
    with pytest.raises(ValueError, match="shared memory"):
        decode_attn.decode_plan(1, 4096, 1, 4096, 256, 132)


def _merge(parts):
    """(m, l, acc) partials merged in order: (M, sum l e^(m - M),
    sum acc e^(m - M))."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    return (M, sum(l * torch.exp(m - M) for m, l, _ in parts),
            sum(a * torch.exp(m - M)[..., None] for m, _, a in parts))


def _split_merge(q, k, v, valid, split, chunk=None):
    """K9's arithmetic in plain PyTorch: per slice of ``split`` positions
    below ``valid`` the scores' max m, sum l and unnormalised P V, then the
    slices merged in order as the last block of a group merges them (with
    ``chunk``: chunks of that many slices first, then the chunks)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, KV, H // KV, hd)
    parts = []
    for l0 in range(0, valid, split):
        ks, vs = k[:, l0:min(l0 + split, valid)], v[:, l0:min(l0 + split,
                                                              valid)]
        s = torch.einsum("bgrd,btgd->bgrt", qh, ks) * hd ** -0.5
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bgrt,btgd->bgrd", p, vs)))
    if chunk is not None:
        parts = [_merge(parts[c:c + chunk])
                 for c in range(0, len(parts), chunk)]
    _, den, num = _merge(parts)
    return (num / den[..., None]).reshape(B, 1, H, hd)


@pytest.mark.parametrize("B,L,H,KV,hd,valid", [
    (2, 200, 4, 1, 256, 200), (2, 200, 4, 1, 256, 17),
    (1, 300, 16, 1, 256, 299), (2, 130, 9, 3, 64, 130),
    (1, 64, 8, 8, 128, 1), (2, 200, 4, 4, 80, 150), (1, 300, 8, 2, 120, 300)])
def test_flash_decode_split_merge_matches_pallas(B, L, H, KV, hd, valid):
    """The kernel's slices (``decode_plan`` on a small card, so a cache of
    a few hundred positions splits) merged in slice order, in one level and
    in two (chunks of about sqrt(n) slices, then the chunks), agree with
    the Pallas kernel in interpret mode."""
    q, k, v = _qkv(B, 1, L, H, KV, hd, seed=L + valid)
    plan = decode_attn.decode_plan(B, L, KV, H // KV, hd, 2)
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          valid, block_l=32, interpret=True)
    for split in {plan.split, 7}:
        n = -(-valid // split)
        for chunk in (None, max(8, int(np.ceil(np.sqrt(n))))):
            _close(_split_merge(*map(torch.from_numpy, (q, k, v)), valid,
                                split, chunk), want)


def test_flash_decode_valid_len_defaults_to_the_whole_cache():
    q, k, v = _qkv(2, 1, 32, 4, 2, 64, seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert torch.equal(ops.gqa_flash_decode(tq, tk, tv),
                       ops.gqa_flash_decode(tq, tk, tv, 32))


@pytest.mark.parametrize("Sq,Sk,q_offset,window,causal", [
    (40, 40, 0, None, True),
    (40, 40, 0, 12, True),
    (8, 40, 32, None, True),            # continuation of a prefill
    (8, 40, 32, 12, True),
    (20, 30, 0, None, False),           # bidirectional, Sq != Sk
])
def test_plain_flash_attention_matches_jax(Sq, Sk, q_offset, window, causal):
    q, k, v = _qkv(2, Sq, Sk, 6, 2, 16, seed=Sq + Sk)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window, q_block=16,
                                 kv_block=16, q_offset=q_offset,
                                 causal=causal)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                window=window, q_offset=q_offset,
                                causal=causal)
    _close(got, want)
    want_ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=window,
                                         q_offset=q_offset, causal=causal)
    _close(tattn.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                     window=window, q_offset=q_offset,
                                     causal=causal), want_ref)


@pytest.mark.parametrize("cache_len,window", [(None, None), (21, None),
                                              (30, 8), (None, 8)])
def test_plain_decode_attention_matches_jax(cache_len, window):
    q, k, v = _qkv(2, 1, 30, 4, 2, 16, seed=11)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), cache_len=cache_len,
                                  window=window)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                 cache_len=cache_len, window=window)
    _close(got, want)


def test_decode_attention_kernel_hook_is_called():
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 8, 2, 1, 16, seed=0))
    seen = []

    def kernel(*args):
        seen.append(args[3])
        return torch.zeros_like(q)

    out = tattn.decode_attention(q, k, v, cache_len=5, kernel=kernel)
    assert seen == [5] and torch.equal(out, torch.zeros_like(q))


# --------------------------------------------------------------------------
# K8a's schedule: the tiles it walks, the masks it skips, its dispatch order
# --------------------------------------------------------------------------

def _fwd_emulated(q, k, v, plan, causal, window):
    """K8a's tile walk in plain PyTorch: for each query tile of
    ``plan.positions`` positions, the key tiles of ``plan.key_tile`` keys
    from the first one a position sees, ``plan.n_tiles[t]`` of them, with an
    online softmax; per-element masks only on tiles that cross the
    diagonal, the window's edge or S, as the kernel's ``inside`` test
    decides.  Returns (o, lse) in the plain version's layout."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep, kt, P = H // KV, plan.key_tile, plan.positions
    qh = q.reshape(B, S, KV, rep, hd)
    o = torch.zeros(B, S, KV, rep, hd)
    lse = torch.zeros(B, KV, rep, S)
    for t, n in enumerate(plan.n_tiles):
        q0 = t * P
        qp = torch.arange(q0, min(q0 + P, S))
        k_lo = 0 if window is None else max(0, q0 - window + 1)
        qt = qh[:, qp]                                  # [B, P, KV, rep, hd]
        m = torch.full((B, len(qp), KV, rep), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for j in range(k_lo // kt, k_lo // kt + n):
            kp = torch.arange(j * kt, (j + 1) * kt)
            ks, vs = (torch.zeros(B, kt, KV, hd) for _ in range(2))
            ks[:, kp < S], vs[:, kp < S] = k[:, kp[kp < S]], v[:, kp[kp < S]]
            s = torch.einsum("bpgrd,bkgd->bpgrk", qt, ks) * hd ** -0.5
            inside = (j * kt + kt <= S
                      and (not causal or j * kt + kt - 1 <= q0)
                      and (window is None or qp[-1] - j * kt < window))
            if not inside:
                d = qp[:, None] - kp[None, :]
                ok = (kp[None, :] < S) & ((d >= 0) | (not causal))
                if window is not None:
                    ok &= d < window
                s = torch.where(ok[None, :, None, None, :], s,
                                torch.full_like(s, -1e30))
                p_mask = ok[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if not inside:
                p = torch.where(p_mask, p, torch.zeros_like(p))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bpgrk,bkgd->bpgrd", p, vs)
            m = m_new
        o[:, qp] = acc / l[..., None]
        lse[..., qp] = (m + torch.log(l)).permute(0, 2, 3, 1)
    return o.reshape(B, S, H, hd), lse


FWD_CASES = [       # B, S, H, KV, hd, window, causal
    (1, 100, 3, 1, 64, None, True),     # rep 3: 21 positions, 64-key tiles
    (2, 150, 4, 1, 64, 40, True),       # window ends mid-tile
    (1, 140, 4, 1, 256, None, True),    # hd 256: 64-key tiles
    (1, 130, 8, 4, 128, 24, True),      # hd 128: 32-key tiles
    (1, 90, 2, 2, 64, None, False),     # no causal mask
    (1, 20, 64, 1, 64, None, True),     # rep 64: one position a tile
    (1, 150, 4, 4, 80, None, True),     # hd 80: 64-key tiles, rep 1
    (1, 110, 8, 2, 120, 24, True),      # hd 120: 32-key tiles, rep 4
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", FWD_CASES)
def test_fwd_schedule_emulation_matches_pallas(B, S, H, KV, hd, window,
                                               causal):
    q, k, v = _qkv(B, S, S, H, KV, hd, seed=S + 7 * H + hd)
    o_j, lse_j = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=hd ** -0.5, causal=causal, window=window,
                             q_block=16, kv_block=16, interpret=True)
    plan = flash_attn.fwd_plan(B, S, H, KV, hd, causal, window)
    o, lse = _fwd_emulated(*map(torch.from_numpy, (q, k, v)), plan, causal,
                           window)
    _close(o, o_j)
    _close(lse, np.asarray(lse_j)[..., :S])


@pytest.mark.parametrize("S,H,KV,hd,window", [
    (1024, 4, 1, 256, None), (1024, 4, 1, 256, 512), (1024, 9, 3, 64, None),
    (1000, 4, 1, 256, 512), (333, 3, 3, 128, None), (37, 64, 1, 64, 5),
    (1024, 32, 32, 80, None), (1000, 32, 32, 80, None),
    (4608, 32, 8, 120, 4096)])
def test_fwd_plan_order_is_heavy_first_and_covers_the_visible_tiles(
        S, H, KV, hd, window):
    """Each query tile walks exactly the key tiles its positions see; the
    launch order puts every group's tile of one rank before the next rank,
    the longest first under a causal mask; and on the card's block slots
    that order ends no later than the parent's grid, whose (b, g) groups
    took their tiles in turn."""
    B, rep = 4, H // KV
    plan = flash_attn.fwd_plan(B, S, H, KV, hd, True, window)
    kt, P = plan.key_tile, plan.positions
    assert (kt, P) == (flash_attn.FWD_KEYS[hd], 64 // rep)
    assert len(plan.n_tiles) == -(-S // P)
    keys = np.arange(S)
    for t, n in enumerate(plan.n_tiles):
        pos = np.arange(t * P, min((t + 1) * P, S))
        d = pos[:, None] - keys[None, :]
        seen = np.any((d >= 0) & ((window is None) | (d < (window or 1))), 0)
        tiles = sorted(set((keys[seen] // kt).tolist()))
        assert tiles == list(range(tiles[0], tiles[0] + n))
    costs = plan.costs()
    assert len(costs) == B * KV * len(plan.n_tiles)
    assert costs[:B * KV] == [max(plan.n_tiles) + 1] * (B * KV)
    if window is None:
        assert costs == sorted(costs, reverse=True)
    by_group = [n + 1 for _ in range(B * KV) for n in reversed(plan.n_tiles)]
    assert plan.makespan <= flash_attn._slot_makespan(by_group, plan.slots)
    assert plan.makespan >= max(plan.ideal, max(costs))


@pytest.mark.parametrize("hd,padded,fwd,dq,dkv", [
    (64, 64, (64, 2), (64, 2), (64, 2)),
    (80, 96, (64, 2), (32, 2), (64, 1)),
    (120, 128, (32, 2), (32, 2), (64, 1)),
    (128, 128, (32, 2), (32, 2), (64, 1)),
    (256, 256, (64, 1), (32, 1), (32, 1)),
])
def test_tiles_at_every_head_dim_match_the_kernels(hd, padded, fwd, dq, dkv):
    """The plans' tile tables at every head dim the kernels are built for,
    worked out by hand from csrc's FwdTile / DqTile / DkvTile: the row
    width in shared memory (hd 80 and 120 padded to 96 and 128, so their
    float4 column groups divide the threads), keys a tile and blocks an
    SM (the shared memory of Q, K, V, P or ds rows of padded + 4 floats
    against the SM's 232,448 bytes, 1 KB a block reserved)."""
    assert hd in flash_attn.HEAD_DIMS and hd in decode_attn.HEAD_DIMS
    assert flash_attn.padded_hd(hd) == padded
    assert padded % 32 == 0 and hd <= padded < hd + 32
    assert (flash_attn.FWD_KEYS[hd],
            flash_attn._fwd_blocks_per_sm(hd, fwd[0])) == fwd
    assert (flash_attn.DQ_KEYS[hd],
            flash_attn._dq_blocks_per_sm(hd, dq[0], 64)) == dq
    assert (flash_attn.DKV_KEYS[hd],
            flash_attn._dkv_blocks_per_sm(hd, dkv[0], 64)) == dkv
    for plan in (flash_attn.fwd_plan(4, 1024, 32, 8, hd),
                 flash_attn.dq_plan(4, 1024, 32, 8, hd),
                 flash_attn.dkv_plan(4, 1024, 32, 8, hd)):
        assert plan.key_tile == {flash_attn.FwdPlan: fwd,
                                 flash_attn.DqPlan: dq,
                                 flash_attn.DkvPlan: dkv}[type(plan)][0]
    assert flash_attn.fwd_plan(4, 1024, 32, 8, hd).slots == 132 * fwd[1]
