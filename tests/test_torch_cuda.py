"""The CUDA kernels (K1 Gram sum and the fused MK-MMD term, K2 fusion
conv, K3 quant pack, K4 quant unpack, K5 top-k select, K6 / K7 EF rows,
K8a flash attention forward, K8b / K8c its backward, K9 flash-decode)
against their plain PyTorch versions
on the card, the wrappers' refusals, and the engine, the serving path and
an LM training step on the card.

Imports torch and the port only (no JAX), so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tests marked ``cuda`` skip where torch finds no CUDA device.  Tolerances:
the Gram sum is a float32 sum of n*m positive terms taken in another order
than the plain version's, so the two agree to rtol 1e-5; the fused MK-MMD
term is a difference of three such sums, held to rtol 1e-5 with an atol of
1e-6 (it is O(0.1)), and its gradients like the Gram sum's; the fusion conv
sums K = 2C products per output, held to 1e-5 of the output's scale; the
gradient is a difference of two sums that cancel in part, held to rtol
1e-4 with an atol of 1e-6 of its scale.  K3, K4 and K5 are the same IEEE
float32 operations as their plain versions and are held with
``torch.equal``.  K8a and K9 sum each softmax row in another order than
the plain versions' full softmax (tiles with online rescaling, cache
slices merged in a second pass): atol 1e-5 / rtol 1e-4; K9's
log-sum-exp atol 1e-5 / rtol 1e-5 (|lse| < 15).  K8b and K8c sum
dq over up to S keys and dk / dv over up to S * rep rows in another order
than the plain version's full products: rtol 1e-4 with an atol of 1e-5 of
each gradient's largest element.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_inputs import (TOPK_EDGE_T, WIDTHS, fusion_inputs,
                           rng_pair, topk_edge_case)

from repro_torch.kernels import compress_pack as tcp
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import fusion_conv as tfc
from repro_torch.kernels import mk_mmd as tmk
from repro_torch.kernels import ops as tops
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the CUDA wrappers: refuse what the kernels do not take
# --------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x, y = map(torch.from_numpy, rng_pair(4, 4, 8, 0))
    before = (tmk.gram_sum_cuda.launches, tfc.fusion_conv_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.gram_sum_cuda(x, y, torch.tensor(1.0), WIDTHS)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.fusion_conv_cuda(x, y, torch.zeros(16, 8))
    # the CPU path runs the plain versions and launches nothing
    tops.mk_mmd2(x, y, WIDTHS)
    tops.fused_fusion_conv(x, y, torch.zeros(16, 8))
    assert (tmk.gram_sum_cuda.launches,
            tfc.fusion_conv_cuda.launches) == before


def test_fused_mk_mmd2_wrappers_refuse_cpu_tensors():
    x, y = map(torch.from_numpy, rng_pair(4, 4, 8, 0))
    before = _mmd_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tmk.mk_mmd2_cuda(x, y, WIDTHS)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.mk_mmd2_grad_cuda(x, y, torch.ones(1), torch.ones(1), WIDTHS)
    # the CPU path runs the plain versions and launches nothing
    tx = x.clone().requires_grad_(True)
    torch.autograd.grad(tops.mk_mmd2(tx, y, WIDTHS), tx)
    assert _mmd_launches() == before


def _mmd_launches():
    return (tmk.mk_mmd2_cuda.launches, tmk.mk_mmd2_grad_cuda.launches,
            tmk.gram_sum_cuda.launches)


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(10, 10, 64), (32, 32, 64), (37, 53, 64),
                                   (300, 200, 100)])
def test_gram_sum_kernel_matches_plain(cuda_device, n, m, d):
    x, y = (torch.from_numpy(a).to(cuda_device)
            for a in rng_pair(n, m, d, n + m))
    sigma = torch.tensor(3.7, device=cuda_device)
    before = tmk.gram_sum_cuda.launches
    got = tmk.gram_sum_cuda(x, y, sigma, WIDTHS)
    want = tmk.gram_sum_plain(x, y, sigma, WIDTHS)
    torch.cuda.synchronize()
    assert tmk.gram_sum_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    assert torch.equal(got, tmk.gram_sum_cuda(x, y, sigma, WIDTHS))


@pytest.mark.cuda
def test_gram_sum_kernel_grad_matches_plain(cuda_device):
    x, y = rng_pair(10, 10, 64, 3)
    sigma = torch.tensor(20.0, device=cuda_device)
    grads = []
    for fn in (tmk.gram_sum, tmk.gram_sum_plain):
        tx = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
        ty = torch.from_numpy(y).to(cuda_device).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(tx, ty, sigma, WIDTHS), (tx, ty)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-6 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(10, 10, 64), (8, 8, 576), (37, 53, 64),
                                   (1, 1, 64), (64, 64, 300), (3, 60, 5)])
def test_fused_mk_mmd2_kernels_match_plain(cuda_device, n, m, d):
    """The fused forward (MMD^2 and sigma) and backward (dx, dy) against
    the plain versions, one launch each, bitwise equal when run again."""
    x, y = (torch.from_numpy(a).to(cuda_device)
            for a in rng_pair(n, m, d, n + 2 * m))
    g = torch.tensor([0.37], device=cuda_device)
    before = _mmd_launches()
    out = tmk.mk_mmd2_cuda(x, y, WIDTHS)
    dx, dy = tmk.mk_mmd2_grad_cuda(x, y, out[1:], g, WIDTHS)
    torch.cuda.synchronize()
    assert _mmd_launches() == (before[0] + 1, before[1] + 1, before[2])
    value, sigma = tmk.mk_mmd2_plain(x, y, WIDTHS)
    torch.testing.assert_close(out[1], sigma, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(out[0], value, rtol=1e-5, atol=1e-6)
    want = tmk.mk_mmd2_grad_plain(x, y, out[1], g, WIDTHS)
    for got, w in zip((dx, dy), want):
        torch.testing.assert_close(got, w, rtol=1e-4,
                                   atol=1e-6 * w.abs().max().item())
    again = tmk.mk_mmd2_cuda(x, y, WIDTHS)
    assert torch.equal(out, again)
    for a, b in zip((dx, dy), tmk.mk_mmd2_grad_cuda(x, y, again[1:], g,
                                                    WIDTHS)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mk_mmd2_routes_by_shape_on_the_card(cuda_device):
    """ops.mk_mmd2 on the card: n, m <= 64 take the fused term (one launch
    each way, no dy for a detached y), larger ones three Gram sums; both
    agree with autograd through the plain oracle."""
    from repro_torch.kernels import ref as tref
    for n, m, fused in ((10, 10, True), (100, 30, False)):
        x, y = (torch.from_numpy(a).to(cuda_device)
                for a in rng_pair(n, m, 48, n))
        tx = x.clone().requires_grad_(True)
        before = _mmd_launches()
        (gx,) = torch.autograd.grad(tops.mk_mmd2(tx, y, WIDTHS), tx)
        torch.cuda.synchronize()
        want = (1, 1, 0) if fused else (0, 0, 3)
        assert tuple(a - b for a, b in zip(_mmd_launches(), before)) == want
        rx = x.clone().requires_grad_(True)
        (wx,) = torch.autograd.grad(tref.mk_mmd2_ref(rx, y, WIDTHS), rx)
        torch.testing.assert_close(gx, wx, rtol=1e-4,
                                   atol=1e-6 * wx.abs().max().item())


@pytest.mark.cuda
def test_fused_mk_mmd2_refuses_bad_inputs(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    one = torch.ones(1, device=cuda_device)
    before = _mmd_launches()
    with pytest.raises(ValueError, match="shapes"):
        tmk.mk_mmd2_cuda(torch.zeros(65, 8, device=cuda_device), x, WIDTHS)
    with pytest.raises(ValueError, match="shapes"):
        tmk.mk_mmd2_cuda(x, torch.zeros(4, 7, device=cuda_device), WIDTHS)
    with pytest.raises(ValueError, match="float32"):
        tmk.mk_mmd2_cuda(x, x.double(), WIDTHS)
    with pytest.raises(ValueError, match="contiguous"):
        tmk.mk_mmd2_cuda(x, torch.zeros(8, 4, device=cuda_device).T, WIDTHS)
    with pytest.raises(ValueError, match="widths"):
        tmk.mk_mmd2_cuda(x, x, (1.0,) * 9)
    with pytest.raises(ValueError, match="sigma"):
        tmk.mk_mmd2_grad_cuda(x, x, torch.ones(1), one, WIDTHS)
    with pytest.raises(ValueError, match="g must"):
        tmk.mk_mmd2_grad_cuda(x, x, one, torch.ones(2, device=cuda_device),
                              WIDTHS)
    assert _mmd_launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("T,C", [(490, 64), (100352, 64), (1001, 64),
                                 (77, 40), (130, 100), (8192, 576), (33, 30),
                                 (20000, 30)])
def test_fusion_conv_kernel_matches_plain(cuda_device, T, C):
    """K2 at the CNN's shapes, smollm-135m's LM fusion (8,192 x 576), ragged
    ones and C % 4 != 0 (the scalar path, in both tilings), bitwise equal
    when run again."""
    fg, fl, w = (torch.from_numpy(a).to(cuda_device)
                 for a in fusion_inputs((T,), C, T + C))
    before = tfc.fusion_conv_cuda.launches
    got = tfc.fusion_conv_cuda(fg, fl, w)
    want = tfc.fusion_conv_plain(fg, fl, w)
    torch.cuda.synchronize()
    assert tfc.fusion_conv_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, tfc.fusion_conv_cuda(fg, fl, w))


@pytest.mark.cuda
def test_fusion_conv_cases_reach_both_tilings(cuda_device):
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plans = {tfc.conv_plan(T, C, n_sm) for T, C in
             [(490, 64), (100352, 64), (8192, 576), (33, 30), (20000, 30)]}
    assert plans == {tfc.SMALL, tfc.LARGE}


@pytest.mark.cuda
@pytest.mark.parametrize("T,C", [(490, 64), (20000, 64)])
def test_fusion_conv_kernel_takes_unaligned_views(cuda_device, T, C):
    """Inputs that start 4 bytes past a 16-byte boundary take the scalar
    path of the same kernel."""
    fg, fl, w = (torch.from_numpy(a).to(cuda_device)
                 for a in fusion_inputs((T,), C, 7))
    views = []
    for x in (fg, fl, w):
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        views.append(view)
    assert all(v.data_ptr() % 16 for v in views)
    got = tfc.fusion_conv_cuda(*views)
    want = tfc.fusion_conv_plain(fg, fl, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, tfc.fusion_conv_cuda(*views))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        tmk.gram_sum_cuda(x, x.double(), torch.tensor(1.0,
                                                      device=cuda_device),
                          WIDTHS)
    with pytest.raises(ValueError):
        tmk.gram_sum_cuda(x, x, torch.tensor(1.0, device=cuda_device),
                          (1.0,) * 9)
    with pytest.raises(ValueError):
        tfc.fusion_conv_cuda(x.T, x.T, torch.zeros(8, 4, device=cuda_device))
    # K2's lean launch path still checks shapes, types and devices
    before = tfc.fusion_conv_cuda.launches
    with pytest.raises(ValueError, match="shapes"):
        tfc.fusion_conv_cuda(x, x, torch.zeros(8, 8, device=cuda_device))
    with pytest.raises(ValueError, match="shapes"):
        tfc.fusion_conv_cuda(x, x[:3], torch.zeros(16, 8, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        tfc.fusion_conv_cuda(x, x.double(),
                             torch.zeros(16, 8, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA|float32"):
        tfc.fusion_conv_cuda(x, x, torch.zeros(16, 8))
    assert tfc.fusion_conv_cuda.launches == before


# --------------------------------------------------------------------------
# the wire-codec kernels K3 / K4 / K5
# --------------------------------------------------------------------------

def _codec_launches():
    return (tcp.quant_pack_cuda.launches, tcp.quant_unpack_cuda.launches,
            tcp.topk_select_cuda.launches)


def test_codec_wrappers_refuse_cpu_tensors():
    x, u, s = torch.ones(8), torch.full((8,), 0.5), torch.ones(1)
    before = _codec_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tcp.quant_pack_cuda(x, s, u)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.quant_pack_multi_cuda([x], [u])
    with pytest.raises(ValueError, match="CUDA"):
        tcp.quant_unpack_cuda(torch.zeros(8, dtype=torch.int8), s)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.quant_unpack_multi_cuda([torch.zeros(8, dtype=torch.int8)], [s])
    with pytest.raises(ValueError, match="CUDA"):
        tcp.topk_select_cuda(x, s)
    # the CPU path runs the plain versions and launches nothing
    tcp.quant_pack_multi([x, x], None)
    tcp.quant_unpack(tcp.quant_pack(x, s, u), s)
    tcp.quant_unpack_multi([tcp.quant_pack(x, s, u)] * 2, [s, s])
    tcp.topk_select(x, s)
    assert _codec_launches() == before


def _quant_case(n, bits, seed, device, clamp=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    u = torch.from_numpy(rng.random(n, dtype=np.float32))
    scale = x.abs().max() / (127 if bits == 8 else 7)
    if clamp:
        scale = scale * 0.5
    return x.to(device), u.to(device), scale.reshape(1).to(device)


QUANT_CASES = [(8, 1_605_632), (8, 10), (8, 1001), (8, 4097), (4, 1_605_632),
               (4, 10), (4, 1002), (4, 4098)]


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [False, True], ids=["scaled", "clamped"])
@pytest.mark.parametrize("bits,n", QUANT_CASES)
def test_quant_kernels_match_plain(cuda_device, bits, n, clamp):
    x, u, scale = _quant_case(n, bits, n + bits, cuda_device, clamp)
    before = _codec_launches()
    got = tcp.quant_pack_cuda(x, scale, u, bits=bits)
    want = tcp.quant_pack_plain(x, scale, u, bits=bits)
    y = tcp.quant_unpack_cuda(got, scale, bits=bits, n=n)
    y_plain = tcp.quant_unpack_plain(got, scale, bits=bits, n=n)
    torch.cuda.synchronize()
    assert _codec_launches() == (before[0] + 1, before[1] + 1, before[2])
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(y, y_plain)
    # the same codes from the CPU's plain version
    assert torch.equal(got.cpu(), tcp.quant_pack_plain(
        x.cpu(), scale.cpu(), u.cpu(), bits=bits))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_kernels_take_unaligned_views(cuda_device, bits):
    x, u, scale = _quant_case(4099, bits, bits, cuda_device)
    xs, us = x[1:4097], u[3:4099]          # contiguous, not 16-byte aligned
    got = tcp.quant_pack_cuda(xs, scale, us, bits=bits)
    assert torch.equal(got, tcp.quant_pack_plain(xs, scale, us, bits=bits))
    q = got[1:]                             # not 4-byte aligned
    n = q.numel() if bits == 8 else 2 * q.numel() - 1    # odd n for int4
    assert torch.equal(tcp.quant_unpack_cuda(q, scale, bits=bits, n=n),
                       tcp.quant_unpack_plain(q, scale, bits=bits, n=n))


# CNN_MNIST's eight leaves (conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b)
MNIST_LEAVES = [800, 32, 51_200, 64, 1_605_632, 512, 5_120, 10]


def _message(sizes, bits, seed, device):
    """One code tensor and scale a leaf (int4 leaves hold ceil(n / 2)
    bytes) from seeded numpy draws."""
    rng = np.random.default_rng(seed)
    packed, scales = [], []
    for n in sizes:
        x, u, scale = _quant_case(n + (n % 2 if bits == 4 else 0), bits,
                                  int(rng.integers(1 << 30)), device)
        packed.append(tcp.quant_pack_cuda(x, scale, u, bits=bits))
        scales.append(scale)
    return packed, scales


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["cnn_mnist", "odd_unaligned", "70_leaves"])
def test_quant_unpack_multi_matches_plain(cuda_device, bits, case):
    """K4 over a whole message equals the plain version leaf by leaf, in
    one launch per 64 leaves."""
    sizes = {"cnn_mnist": MNIST_LEAVES, "odd_unaligned": [4097, 33, 1000],
             "70_leaves": [37 * i + 1 for i in range(70)]}[case]
    packed, scales = _message(sizes, bits, len(sizes) + bits, cuda_device)
    if case == "odd_unaligned":
        # views that start off the 4-byte boundary
        packed = [q[1:] for q in packed]
        sizes = [q.numel() if bits == 8 else 2 * q.numel() - 1
                 for q in packed]
    before = tcp.quant_unpack_cuda.launches
    got = tcp.quant_unpack_multi_cuda(packed, scales, bits=bits, ns=sizes)
    torch.cuda.synchronize()
    assert tcp.quant_unpack_cuda.launches == before + -(-len(sizes) // 64)
    want = tcp.quant_unpack_multi_plain(packed, scales, bits=bits, ns=sizes)
    assert [t.numel() for t in got] == sizes
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert g.data_ptr() % 16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [True, False], ids=["offsets", "half"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["cnn_mnist", "odd_unaligned", "70_leaves"])
def test_quant_pack_multi_matches_plain(cuda_device, bits, case, offsets):
    """K3 over a whole message, scales included, equals the plain version
    leaf by leaf, in two launches per 64 leaves: odd int4 leaves, views off
    the 16-byte boundary, a leaf of zeros, more leaves than a launch
    takes, with the caller's offsets and with u = 0.5."""
    sizes = {"cnn_mnist": MNIST_LEAVES, "odd_unaligned": [4097, 33, 1000, 1],
             "70_leaves": [37 * i + 1 for i in range(70)]}[case]
    rng = np.random.default_rng(len(sizes) + bits)
    xs = [torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
          .to(cuda_device)[1:] if case == "odd_unaligned" else
          torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          .to(cuda_device) for n in sizes]
    if case == "odd_unaligned":
        xs[-1] = torch.zeros(1, device=cuda_device)
    us = [torch.from_numpy(rng.random(n + (n % 2 if bits == 4 else 0),
                                      dtype=np.float32)).to(cuda_device)
          for n in sizes] if offsets else None
    before = tcp.quant_pack_cuda.launches
    got = tcp.quant_pack_multi_cuda(xs, us, bits=bits)
    again = tcp.quant_pack_multi_cuda(xs, us, bits=bits)
    torch.cuda.synchronize()
    assert tcp.quant_pack_cuda.launches == before + 4 * -(-len(sizes) // 64)
    want = tcp.quant_pack_multi_plain(xs, us, bits=bits)
    assert len(got) == len(sizes)
    for (q, sc), (q2, sc2), (wq, ws) in zip(got, again, want):
        assert q.dtype == wq.dtype and torch.equal(q, wq)
        assert sc.shape == (1,) and torch.equal(sc, ws)
        assert torch.equal(q, q2) and torch.equal(sc, sc2)
        assert q.data_ptr() % 16 == 0
    # the same codes and scales from the CPU's plain version
    cpu = tcp.quant_pack_multi_plain(
        [x.cpu() for x in xs], None if us is None else [u.cpu() for u in us],
        bits=bits)
    for (q, sc), (cq, cs) in zip(got, cpu):
        assert torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), cs)


@pytest.mark.cuda
def test_quant_pack_multi_replays_in_a_cuda_graph(cuda_device):
    """K3's two launches captured once and replayed on new leaves: each
    replay's codes and scales equal the plain version's (the max|x| slots
    and tickets reset themselves)."""
    rng = np.random.default_rng(3)
    xs = [torch.zeros(n, device=cuda_device) for n in MNIST_LEAVES]
    us = [torch.zeros(n, device=cuda_device) for n in MNIST_LEAVES]
    tcp.quant_pack_multi_cuda(xs, us)               # slots made outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tcp.quant_pack_multi_cuda(xs, us)
    for scale in (1.0, 1e-3, 0.0):
        for x, u in zip(xs, us):
            x.copy_(torch.from_numpy(scale * rng.standard_normal(
                x.numel()).astype(np.float32)))
            u.copy_(torch.from_numpy(rng.random(u.numel(),
                                                dtype=np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        for (q, sc), (wq, ws) in zip(out, tcp.quant_pack_multi_plain(xs, us)):
            assert torch.equal(q, wq) and torch.equal(sc, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
def test_quant_pack_multi_reads_the_ladder_level(cuda_device, level):
    """K3 at a level of the int8 ladder (4, 8), the level a device int32:
    qmax 7 at level 0, 127 at level 1.  Codes and scales equal the plain
    version's on the card and on the CPU, in two launches; level 1 is the
    capacity encode; a level on another device or a qmax past the capacity
    is refused."""
    rng = np.random.default_rng(7 + level)
    xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          .to(cuda_device) for n in MNIST_LEAVES]
    us = [torch.from_numpy(rng.random(n, dtype=np.float32)).to(cuda_device)
          for n in MNIST_LEAVES]
    lv = torch.tensor(level, dtype=torch.int32, device=cuda_device)
    qmax = (7.0, 127.0)
    before = tcp.quant_pack_cuda.launches
    got = tcp.quant_pack_multi_cuda(xs, us, level=lv, ladder_qmax=qmax)
    assert tcp.quant_pack_cuda.launches - before == 2
    want = tcp.quant_pack_multi_plain(xs, us, level=lv, ladder_qmax=qmax)
    cpu = tcp.quant_pack_multi_plain([x.cpu() for x in xs],
                                     [u.cpu() for u in us], level=lv.cpu(),
                                     ladder_qmax=qmax)
    cap = tcp.quant_pack_multi_cuda(xs, us)
    for (q, sc), (wq, ws), (cq, cs), (kq, ks) in zip(got, want, cpu, cap):
        assert torch.equal(q, wq) and torch.equal(sc, ws)
        assert torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), cs)
        if level == 1:
            assert torch.equal(q, kq) and torch.equal(sc, ks)
        else:
            assert int(q.abs().max()) <= 8
    with pytest.raises(ValueError, match="int32 tensor on"):
        tcp.quant_pack_multi_cuda(xs, us, level=lv.cpu(), ladder_qmax=qmax)
    with pytest.raises(ValueError, match="ladder qmax"):
        tcp.quant_pack_multi_cuda(xs, us, level=lv, ladder_qmax=(200.0,))


@pytest.mark.cuda
def test_quant_pack_multi_level_follows_the_buffer_across_replays(
        cuda_device):
    """One captured message encode replayed at level 0, 1, then 0 again,
    the level written into its buffer between replays: the codes and
    scales follow the level (a graph that baked the level in would give
    level 0's codes three times)."""
    rng = np.random.default_rng(5)
    xs = [torch.zeros(n, device=cuda_device) for n in MNIST_LEAVES]
    us = [torch.zeros(n, device=cuda_device) for n in MNIST_LEAVES]
    lv = torch.zeros((), dtype=torch.int32, device=cuda_device)
    qmax = (7.0, 127.0)
    tcp.quant_pack_multi_cuda(xs, us, level=lv, ladder_qmax=qmax)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tcp.quant_pack_multi_cuda(xs, us, level=lv, ladder_qmax=qmax)
    seen = []
    for level in (0, 1, 0):
        for x, u in zip(xs, us):
            x.copy_(torch.from_numpy(rng.standard_normal(
                x.numel()).astype(np.float32)))
            u.copy_(torch.from_numpy(rng.random(u.numel(),
                                                dtype=np.float32)))
        lv.fill_(level)
        graph.replay()
        torch.cuda.synchronize()
        want = tcp.quant_pack_multi_plain(xs, us, level=lv,
                                          ladder_qmax=qmax)
        for (q, sc), (wq, ws) in zip(out, want):
            assert torch.equal(q, wq) and torch.equal(sc, ws)
        seen.append(int(out[4][0].abs().max()))
    assert seen[0] <= 8 < seen[1] and seen[2] <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1_605_632, 100_352), (10, 3), (1001, 40),
                                 (4097, 1)])
def test_topk_select_kernel_matches_plain(cuda_device, n, k):
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    t = x.abs().sort().values[-k]
    x[0], x[-1] = -t, t                     # entries exactly at t are kept
    x, t = x.to(cuda_device), t.reshape(1).to(cuda_device)
    before = tcp.topk_select_cuda.launches
    got = tcp.topk_select_cuda(x, t)
    torch.cuda.synchronize()
    assert tcp.topk_select_cuda.launches == before + 1
    assert torch.equal(got, tcp.topk_select_plain(x, t))
    assert got[0] == -t[0] and got[-1] == t[0]
    assert torch.equal(tcp.topk_select_cuda(x[1:], t),
                       tcp.topk_select_plain(x[1:], t))


# n on each side of K5's schedule boundaries, from its tile (a block's
# threads x groups a thread x 4 elements) and one full wave of tiles
TOPK_SIZES = {"1": lambda tile, wave: 1,
              "tile - 1": lambda tile, wave: tile - 1,
              "tile + 1": lambda tile, wave: tile + 1,
              "wave - 4": lambda tile, wave: wave - 4,
              "wave + 3": lambda tile, wave: wave + 3,
              "wave + 4": lambda tile, wave: wave + 4,
              "2 waves + 1": lambda tile, wave: 2 * wave + 1}


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TOPK_EDGE_T)
@pytest.mark.parametrize("where", list(TOPK_SIZES))
def test_topk_select_kernel_edges(cuda_device, where, case):
    """K5 against its plain version bit for bit (as int32, so -0.0 and
    +0.0 differ) on NaN, +-inf, -0.0, ties and t = 0, < 0, +inf, at n on
    each side of the schedule's tile and wave, 16-byte aligned and a view
    4 bytes off (the scalar path); one launch a call."""
    sched = tcp.topk_schedule(1, device=cuda_device)
    tile = sched["threads"] * sched["unroll"] * 4
    n = TOPK_SIZES[where](tile, sched["wave"] * tile)
    x, t = topk_edge_case(n + 1, case)
    buf = torch.from_numpy(x).to(cuda_device)
    t = torch.tensor([t], device=cuda_device)
    for view in (buf[:n], buf[1:]):
        before = tcp.topk_select_cuda.launches
        got = tcp.topk_select_cuda(view, t)
        torch.cuda.synchronize()
        assert tcp.topk_select_cuda.launches == before + 1
        assert torch.equal(_bits(got), _bits(tcp.topk_select_plain(view, t)))


@pytest.mark.cuda
def test_topk_schedule_is_one_block_a_tile(cuda_device):
    """K5 launches one block a tile (threads x groups a thread float4s, or
    floats on the scalar path) at every size; CNN_MNIST's FC leaf fits in
    one wave."""
    for n in (1, 5120, 3136 * 512, 49152 * 576):
        for vec in (True, False):
            sched = tcp.topk_schedule(n, vec=vec, device=cuda_device)
            tile = sched["threads"] * sched["unroll"]
            assert sched["blocks"] == max(1, -(-(n // 4 if vec else n)
                                               // tile))
    sched = tcp.topk_schedule(3136 * 512, device=cuda_device)
    assert sched["blocks"] <= sched["wave"]


@pytest.mark.cuda
def test_codec_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(8, device=cuda_device)
    s = torch.ones(1, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA"):      # a host scale
        tcp.quant_pack_cuda(x, torch.ones(1), x)
    with pytest.raises(ValueError):                    # non-contiguous
        tcp.quant_pack_cuda(torch.zeros(16, device=cuda_device)[::2], s, x)
    with pytest.raises(ValueError):                    # wrong dtype
        tcp.quant_pack_cuda(x.double(), s, x)
    with pytest.raises(ValueError):                    # odd n at int4
        tcp.quant_pack_cuda(x[:7], s, x[:7], bits=4)
    with pytest.raises(ValueError):
        tcp.quant_unpack_cuda(torch.zeros(8, dtype=torch.uint8,
                                          device=cuda_device), s, bits=8)
    with pytest.raises(ValueError):
        tcp.quant_unpack_cuda(torch.zeros(4, dtype=torch.uint8,
                                          device=cuda_device), s, bits=4,
                              n=9)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.topk_select_cuda(x, torch.ones(1))
    with pytest.raises(ValueError):
        tcp.topk_select_cuda(torch.zeros(4, 2, device=cuda_device), s)


@pytest.mark.cuda
@pytest.mark.parametrize("up,down", [("int8", "int4"), ("topk", "identity")])
def test_compressed_round_launches_codec_kernels(cuda_device, up, down):
    from repro_torch.configs import CNN_MNIST, FLConfig
    from repro_torch.data import (FederatedDataset,
                                  artificial_noniid_partition, class_images)
    from repro_torch.fl.server import run_federated_reference
    from repro_torch.models import make_bundle
    bundle = make_bundle(dataclasses.replace(
        CNN_MNIST, input_shape=(12, 12, 1), conv_channels=(4, 8),
        fc_units=(16,)))
    x, y = class_images(10, shape=(12, 12, 1), seed=0, template_seed=0)
    data = FederatedDataset(artificial_noniid_partition(x, y, 4), {"x": x,
                                                                   "y": y})
    fl = FLConfig(clients_per_round=3, local_steps=1, local_batch=4,
                  uplink_codec=up, downlink_codec=down, topk_frac=1 / 16)
    L, C, R = 8, 3, 2
    tcp.quant_pack_cuda.launches = tcp.quant_unpack_cuda.launches = 0
    res = run_federated_reference(bundle, fl, data, rounds=R,
                                  eval_examples=20, device=cuda_device)
    torch.cuda.synchronize()
    # K3 twice per message (max|x| and the scales, then the codes), K4
    # once per message
    pack = (2 * C * R if up == "int8" else 0) + (2 * R if down == "int4"
                                                 else 0)
    unpack = (C * R if up == "int8" else 0) + (R if down == "int4" else 0)
    assert (tcp.quant_pack_cuda.launches,
            tcp.quant_unpack_cuda.launches) == (pack, unpack)
    assert all(t.is_cuda and bool(torch.isfinite(t).all())
               for t in tree_leaves(res.global_state))


# --------------------------------------------------------------------------
# the EF row movers K6 ef_gather / K7 ef_scatter (held with torch.equal:
# both kernels only move bytes)
# --------------------------------------------------------------------------

def _ef_launches():
    return tcp.ef_gather_cuda.launches, tcp.ef_scatter_cuda.launches


def test_ef_wrappers_refuse_cpu_tensors():
    table, idx = torch.zeros(4, 3), torch.tensor([1, 2])
    before = _ef_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tcp.ef_gather_cuda(table, idx)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.ef_scatter_cuda(table, idx, torch.ones(2, 3))
    # the CPU path runs the plain versions and launches nothing
    assert torch.equal(tcp.ef_gather(table, idx), torch.zeros(2, 3))
    assert tcp.ef_scatter(table, idx, torch.ones(2, 3)) is table
    assert torch.equal(table[1:3], torch.ones(2, 3))
    assert _ef_launches() == before


EF_CASES = [((100, 1_605_632), 10), ((37, 3, 7), 5), ((64, 1001), 64),
            ((8, 4), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,k", EF_CASES)
def test_ef_kernels_match_plain(cuda_device, shape, k, dtype):
    rng = np.random.default_rng(shape[0] + k)
    table = torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    rows = torch.from_numpy(rng.standard_normal(
        (k,) + shape[1:]).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.choice(shape[0], k, replace=False)).to(
        dtype).to(cuda_device)
    before = _ef_launches()
    got = tcp.ef_gather_cuda(table, idx)
    assert torch.equal(got, tcp.ef_gather_plain(table, idx))
    want = tcp.ef_scatter_plain(table.clone(), idx, rows)
    ptr = table.data_ptr()
    assert tcp.ef_scatter_cuda(table, idx, rows) is table
    torch.cuda.synchronize()
    assert table.data_ptr() == ptr                  # in place
    assert torch.equal(table, want)                 # untouched rows too
    assert _ef_launches() == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_ef_kernels_take_unaligned_views(cuda_device):
    N, n, k = 9, 1024, 4
    base = torch.randn(N * n + 1, device=cuda_device)
    table = base[1:].view(N, n)                     # 4 bytes off 16
    assert table.data_ptr() % 16
    idx = torch.tensor([7, 0, 3, 8], device=cuda_device)
    rows = torch.randn(k, n, device=cuda_device)
    assert torch.equal(tcp.ef_gather_cuda(table, idx), table[idx])
    want = base.clone()
    want[1:].view(N, n)[idx] = rows
    tcp.ef_scatter_cuda(table, idx, rows)
    assert torch.equal(base, want)          # the element before untouched


@pytest.mark.cuda
def test_ef_scatter_scratch_row_duplicates(cuda_device):
    """Duplicate ids may only target a scratch row past the table; owned
    rows come out exact (tests/test_kernels.py pins the JAX contract)."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((5, 40)).astype(
        np.float32)).to(cuda_device)
    scratch = torch.cat([table, torch.zeros(1, 40, device=cuda_device)])
    rows = torch.from_numpy(rng.standard_normal((4, 40)).astype(
        np.float32)).to(cuda_device)
    safe_idx = torch.tensor([3, 5, 1, 5], dtype=torch.int32,
                            device=cuda_device)
    out = tcp.ef_scatter_cuda(scratch, safe_idx, rows)[:5]
    want = table.clone()
    want[torch.tensor([3, 1])] = rows[torch.tensor([0, 2])]
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_ef_wrappers_refuse_bad_inputs(cuda_device):
    t = torch.zeros(4, 6, device=cuda_device)
    i = torch.tensor([0, 1], device=cuda_device)
    with pytest.raises(ValueError):
        tcp.ef_gather_cuda(t.T, i)                  # not contiguous
    with pytest.raises(ValueError):
        tcp.ef_gather_cuda(t.double(), i)
    with pytest.raises(ValueError):
        tcp.ef_gather_cuda(t, i.reshape(1, 2))
    with pytest.raises(ValueError):
        tcp.ef_scatter_cuda(t, i, torch.zeros(2, 5, device=cuda_device))
    with pytest.raises(IndexError):                 # CPU ids are checked
        tcp.ef_gather_cuda(t, torch.tensor([0, 4]))


# --------------------------------------------------------------------------
# the engine on the card: chunks replayed from captured CUDA graphs equal
# the one-round-at-a-time reference loop.  cuDNN's deterministic
# algorithms are on: its default weight-gradient algorithms differ run to
# run, which no comparison of two runs could hold exactly.
# --------------------------------------------------------------------------

def _small_engine_setup():
    from repro_torch.configs import CNN_MNIST
    from repro_torch.data import (FederatedDataset,
                                  artificial_noniid_partition, class_images)
    from repro_torch.models import make_bundle
    bundle = make_bundle(dataclasses.replace(
        CNN_MNIST, input_shape=(12, 12, 1), conv_channels=(4, 8),
        fc_units=(16,)))
    x, y = class_images(10, shape=(12, 12, 1), seed=0, template_seed=0)

    def data():
        return FederatedDataset(artificial_noniid_partition(x, y, 4),
                                {"x": x[:30], "y": y[:30]})
    return bundle, data


@pytest.mark.cuda
@pytest.mark.parametrize("up,store", [("identity", "device"),
                                      ("topk", "device"), ("topk", "host"),
                                      ("int8", "device")])
def test_engine_graph_replay_matches_reference(cuda_device, up, store):
    from repro_torch.configs import FLConfig
    from repro_torch.fl.server import run_federated, run_federated_reference
    bundle, data = _small_engine_setup()
    fl = FLConfig(algorithm="fedfusion" if up == "topk" else "fedavg",
                  fusion_op="conv", clients_per_round=3, local_steps=2,
                  local_batch=4, uplink_codec=up, topk_frac=1 / 16)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = run_federated_reference(bundle, fl, data(), rounds=4,
                                      eval_examples=32, device=cuda_device)
        before = _ef_launches()
        eng = run_federated(bundle, fl, data(), rounds=4, eval_examples=32,
                            superstep_rounds=2, ef_store=store,
                            device=cuda_device)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    graphs = eng.stats["graphs"]
    assert eng.stats["cuda_graphs"] and len(graphs) == 1
    assert graphs[0]["rounds"] == 2 and graphs[0]["replays"] == 2
    per = graphs[0]["launches_per_replay"]
    n_ef = 8 if up == "topk" else 0                 # EF leaves
    assert (per["ef_gather"], per["ef_scatter"]) == (2 * n_ef, 2 * n_ef)
    patch = n_ef if store == "host" else 0          # second chunk's patch
    # the counters tick in Python only: two warm-up runs and the capture
    got = _ef_launches()
    assert got[0] - before[0] == 3 * 2 * n_ef + patch
    assert got[1] - before[1] == 3 * 2 * n_ef
    for a, b in zip(tree_leaves(eng.global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b), (a - b).abs().max().item()
    assert eng.comm.history == ref.comm.history


@pytest.mark.cuda
def test_engine_auto_chunk_keeps_only_the_runs_graphs(cuda_device):
    """superstep_rounds="auto" captures a 1- and an 8-round graph to time
    them; only the graphs of the run's own chunk lengths remain, each
    replayed once per chunk of its length, and the run equals the
    reference loop."""
    from repro_torch.configs import FLConfig
    from repro_torch.engine import chunk_schedule
    from repro_torch.fl.server import run_federated, run_federated_reference
    bundle, data = _small_engine_setup()
    fl = FLConfig(algorithm="fedavg", clients_per_round=3, local_steps=2,
                  local_batch=4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = run_federated_reference(bundle, fl, data(), rounds=10,
                                      eval_examples=32, device=cuda_device)
        eng = run_federated(bundle, fl, data(), rounds=10, eval_examples=32,
                            superstep_rounds="auto", device=cuda_device)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    st = eng.stats
    lengths = [r1 - r0 for r0, r1 in chunk_schedule(0, 10,
                                                     st["chunk_rounds"])]
    assert st["calibration_s"] > 0 and len(lengths) == st["chunks"]
    assert sorted(g["rounds"] for g in st["graphs"]) == sorted(set(lengths))
    for g in st["graphs"]:
        assert g["replays"] == lengths.count(g["rounds"])
    for a, b in zip(tree_leaves(eng.global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b), (a - b).abs().max().item()
    assert eng.comm.history == ref.comm.history


@pytest.mark.cuda
def test_deadline_chunk_replays_with_new_masks_equal_eager(cuda_device):
    """A ``deadline`` run with chaos (top-k uplink, dense EF): one 2-round
    graph replayed twice, each replay with other staged masks, equals the
    same rounds run eagerly on the card (cuDNN deterministic): the round
    fn with each round's staged cids, weights and mask, the EF rows
    gathered and scattered by indexing."""
    from repro_torch.chaos import ChaosConfig
    from repro_torch.compress import make_codec
    from repro_torch.configs import FLConfig
    from repro_torch.core import init_global_state, make_compressed_round_fn
    from repro_torch.fl.participation import make_policy
    from repro_torch.fl.server import run_federated
    from repro_torch.optim import exp_decay_per_round
    bundle, data = _small_engine_setup()
    chaos = ChaosConfig(speed_sigma=1.2, jitter=0.15, dropout=0.3, seed=17)

    def chaos_data():
        d = data()
        return type(d)(d.clients, d.test, chaos=chaos)

    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  clients_per_round=2, local_steps=2, local_batch=4,
                  uplink_codec="topk", topk_frac=1 / 16,
                  participation="deadline", over_provision=1.5)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eng = run_federated(bundle, fl, chaos_data(), rounds=4,
                            eval_every=0, superstep_rounds=2,
                            ef_store="device", device=cuda_device)
        # the same rounds, eagerly
        src = chaos_data()
        policy = make_policy("deadline")
        state = init_global_state(bundle, fl,
                                  torch.Generator().manual_seed(0),
                                  cuda_device)
        up, down = make_codec("topk", topk_frac=1 / 16), make_codec(
            "identity")
        up.bind(state["model"])
        down.bind(state["model"])
        round_fn = make_compressed_round_fn(bundle, fl, "client_parallel",
                                            up, down)
        ef = [torch.zeros((4, z.numel()), device=cuda_device)
              for z in up.init_state()]
        mirror = tree_map(torch.clone, state["model"])
        lr_at = exp_decay_per_round(fl.lr, fl.lr_decay)
        masks = []
        for r in range(4):
            cids, batches, sizes, part = src.round_chunk(
                1, 3, 2, 4, participation=lambda d: policy.select(
                    d.arrival, d.dropped, fl, 2))
            sizes = sizes * part["mask"] * part["weight"] * part["work"]
            rows = torch.as_tensor(cids[0], device=cuda_device).long()
            pm = torch.from_numpy(part["mask"][0]).to(cuda_device)
            masks.append(part["mask"][0].tolist())
            state, _, new_ef, mirror = round_fn(
                state, {k: torch.from_numpy(v[0]).to(cuda_device)
                        for k, v in batches.items()},
                torch.from_numpy(sizes[0]).to(cuda_device), lr_at(r),
                [e[rows] for e in ef], mirror, (None, None), pm,
                torch.from_numpy(part["staleness"][0]).to(cuda_device))
            for e, n in zip(ef, new_ef):
                e[rows] = n
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    graphs = eng.stats["graphs"]
    assert len(graphs) == 1 and graphs[0]["replays"] == 2
    assert eng.stats["round_cohort"] == 3
    assert masks[0:2] != masks[2:4]
    for a, b in zip(tree_leaves(eng.global_state), tree_leaves(state)):
        assert torch.equal(a, b), (a - b).abs().max().item()
    assert [h["arrived"] for h in eng.comm.history] == \
        [float(sum(m)) for m in masks]


def _cpu_offsets(sizes, device):
    """``noise_fn`` with offsets drawn on the CPU (a seeded CPU generator a
    round) and moved to ``device``: the same numbers on the card and the
    CPU."""
    def noise_fn(r, n_clients):
        gen = torch.Generator().manual_seed(1000 + r)
        return None, [[torch.rand(n, generator=gen).to(device)
                       for n in sizes] for _ in range(n_clients)]
    return noise_fn


@pytest.mark.cuda
def test_controller_level_changes_within_a_captured_chunk(cuda_device):
    """``bytes_budget`` on the int8 ladder at a budget that alternates the
    level every round: one 4-round graph replayed twice changes level
    inside each replay (the codecs read it on the device).  K3 launches
    twice per message; the schedule, bytes and effective fields equal the
    CPU's run from the same state and offsets, the losses within rtol
    1e-3 (cuDNN deterministic)."""
    from repro_torch.configs import FLConfig
    from repro_torch.core import init_global_state
    from repro_torch.fl.server import run_federated
    bundle, data = _small_engine_setup()
    fl = FLConfig(algorithm="fedavg", clients_per_round=2, local_steps=2,
                  local_batch=4, uplink_codec="int8",
                  controller="bytes_budget", ctrl_budget_frac=0.75)
    s0 = init_global_state(bundle, fl, torch.Generator().manual_seed(0),
                           "cpu")
    sizes = [t.numel() for t in tree_leaves(s0["model"])]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cuda", "cpu"):
            runs[dev] = run_federated(
                bundle, fl, data(), rounds=8, eval_every=0,
                superstep_rounds=4, device=dev, global_state=s0,
                noise_fn=_cpu_offsets(sizes, dev), telemetry=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card, cpu = runs["cuda"], runs["cpu"]
    levels = [h["level"] for h in card.comm.history]
    assert levels == [0, 1, 0, 1, 0, 1, 0, 1]
    graphs = card.stats["graphs"]
    assert len(graphs) == 1 and graphs[0]["replays"] == 2
    assert graphs[0]["launches_per_replay"]["quant_pack"] == 2 * 2 * 4
    exact = ("bytes_up", "bytes_down", "level", "eff_quant_bits",
             "tele/level", "tele/effective_bytes")
    for hc, hp in zip(card.comm.history, cpu.comm.history):
        assert {k: hc[k] for k in exact} == {k: hp[k] for k in exact}
        np.testing.assert_allclose(hc["local_loss"], hp["local_loss"],
                                   rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mask", "lowrank"])
def test_sketch_expansion_equal_on_card_and_cpu(cuda_device, mode):
    """The seeded expansion is integer arithmetic: the card picks the
    CPU's mask indices bit for bit; lowrank's G (a log and a cosine) is
    within 1e-6, and so is a decode."""
    from repro_torch.compress import SketchCodec
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(32, 4, 3, 3, generator=gen),
            "m": torch.randn(300, 64, generator=gen),
            "b": torch.randn(1000, generator=gen)}
    cpu = SketchCodec(1 / 16, mode=mode).bind(tree)
    card = SketchCodec(1 / 16, mode=mode).bind(
        tree_map(lambda t: t.to(cuda_device), tree))
    for u in torch.rand(8, generator=gen):
        seed = (u.reshape(1) * 2.0 ** 31).to(torch.int32)
        for i in range(3):
            a = cpu._expand(seed, i)
            b = card._expand(seed.to(cuda_device), i).cpu()
            if a.dtype == torch.int64:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
        noise = [u.reshape(1)] * 3
        pa, _ = cpu.encode(tree, noise=noise)
        pb, _ = card.encode(tree_map(lambda t: t.to(cuda_device), tree),
                            noise=[t.to(cuda_device) for t in noise])
        for x, y in zip(tree_leaves(cpu.decode(pa)),
                        tree_leaves(card.decode(pb))):
            torch.testing.assert_close(y.cpu(), x, rtol=1e-5,
                                       atol=1e-5 * float(x.abs().max()))


# --------------------------------------------------------------------------
# K8a flash attention forward and K9 flash-decode
# --------------------------------------------------------------------------

def _attn_launches():
    return tfa.flash_fwd_cuda.launches, tda.flash_decode_cuda.launches


def _bwd_launches():
    return tfa.flash_bwd_dq_cuda.launches, tfa.flash_bwd_dkv_cuda.launches


def _randn(rng, shape, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def test_attention_wrappers_refuse_cpu_tensors():
    q, kv = torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 1, 64)
    valid = torch.tensor([3], dtype=torch.int32)
    lse = torch.zeros(1, 1, 4, 8)
    before = _attn_launches() + _bwd_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_cuda(q[:, :1], kv, kv, valid)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq_cuda(q, kv, kv, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv_cuda(q, kv, kv, q, lse, lse)
    # the CPU path runs the plain versions and launches nothing
    o, lse = tfa.flash_fwd(q, kv, kv, window=4)
    tfa.flash_bwd(q, kv, kv, o, lse, q, window=4)
    tda.flash_decode(q[:, :1], kv, kv, valid)
    assert _attn_launches() + _bwd_launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", [
    (2, 64, 4, 1, 64, None, True),
    (1, 1000, 4, 1, 256, 512, True),    # gemma3's heads, ragged, window
    (2, 77, 9, 3, 64, 16, True),        # smollm's heads (rep 3), ragged
    (1, 130, 8, 4, 128, None, True),
    (1, 50, 2, 2, 256, None, True),     # rep 1
    # chip_smoke.FLASH_CASES: gemma3-1b global and local, smollm-135m,
    # gemma3-1b local at a ragged length
    (4, 1024, 4, 1, 256, None, True),
    (4, 1024, 4, 1, 256, 512, True),
    (4, 1024, 9, 3, 64, None, True),
    (4, 1000, 4, 1, 256, 512, True),
    # hd 128 at rep 1, 2 and 8, lengths not a multiple of a tile
    (2, 333, 3, 3, 128, None, True),
    (1, 301, 4, 2, 128, 100, True),
    (2, 257, 16, 2, 128, None, True),
    (1, 200, 8, 1, 64, None, False),    # no causal mask
    (1, 96, 4, 1, 256, 40, False),      # a window, no causal mask
    # hd 80 (stablelm-3b: 32 heads over 32) and hd 120 (h2o-danube-3-4b:
    # 32 over 8), the chip_smoke.FLASH_CASES shapes and ragged ones
    (4, 1024, 32, 32, 80, None, True),
    (1, 4608, 32, 8, 120, 4096, True),
    (4, 1000, 32, 32, 80, None, True),
    (2, 333, 4, 4, 80, None, True),
    (1, 301, 8, 2, 120, 100, True),
    (1, 200, 8, 1, 80, None, False),
    (1, 96, 4, 1, 120, 40, False),
])
def test_flash_fwd_kernel_matches_plain(cuda_device, B, S, H, KV, hd,
                                        window, causal):
    rng = np.random.default_rng(S + H)
    q = _randn(rng, (B, S, H, hd), cuda_device)
    k = _randn(rng, (B, S, KV, hd), cuda_device)
    v = _randn(rng, (B, S, KV, hd), cuda_device)
    kw = dict(window=window, causal=causal)
    before = tfa.flash_fwd_cuda.launches
    o, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.launches == before + 1
    torch.testing.assert_close(o, o_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-4)
    o2, lse2 = tfa.flash_fwd_cuda(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 64, 4, 1, 64, None),
    (1, 1000, 4, 1, 256, 512),          # gemma3's heads, ragged, window
    (1, 300, 4, 1, 256, None),          # hd 256, no window
    (2, 77, 9, 3, 64, 16),              # smollm's heads (rep 3), ragged
    (1, 130, 8, 4, 128, None),
    (1, 20, 4, 1, 128, 8),              # S below one tile
    (1, 50, 2, 2, 256, None),           # rep 1
    (1, 9, 64, 1, 64, None),            # rep 64: one position a tile
    (4, 1024, 4, 1, 256, 512),          # gemma3 local: K8b splits its tiles
    (2, 77, 4, 4, 80, 16),              # hd 80, rep 1, ragged, window
    (1, 130, 8, 2, 120, None),          # hd 120, rep 4
    (4, 1024, 32, 32, 80, None),        # stablelm-3b's layers
    (4, 1024, 32, 8, 120, None),        # h2o-danube-3-4b's layers
])
def test_flash_bwd_kernels_match_plain(cuda_device, B, S, H, KV, hd,
                                       window):
    """K8b and K8c against the plain backward, launched once each, and
    bitwise equal when run again on the same inputs."""
    rng = np.random.default_rng(S + H + hd)
    q = _randn(rng, (B, S, H, hd), cuda_device)
    k = _randn(rng, (B, S, KV, hd), cuda_device)
    v = _randn(rng, (B, S, KV, hd), cuda_device)
    do = _randn(rng, (B, S, H, hd), cuda_device)
    o, lse = tfa.flash_fwd_plain(q, k, v, window=window)
    want = tfa.flash_bwd_plain(q, k, v, o, lse, do, window=window)
    dcap = tfa.flash_dcap(do, o, KV)
    before = _bwd_launches()
    dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, window=window)
    dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, window=window)
    torch.cuda.synchronize()
    assert _bwd_launches() == (before[0] + 1, before[1] + 1)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item())
    assert torch.equal(dq, tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap,
                                                 window=window))
    again = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, window=window)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


DKV_SHAPES = [                   # B, S, H, KV, hd, window, split
    (2, 300, 9, 3, 64, None, True),    # smollm's heads, many segments
    (2, 300, 2, 2, 64, 30, False),     # rep 1, window: one segment each
    (1, 1000, 4, 1, 256, 512, True),   # gemma3 local, ragged
    (1, 520, 4, 1, 256, None, True),   # gemma3 global
    (1, 260, 8, 2, 128, 40, True),     # window ends mid-tile
    (1, 9, 64, 1, 64, None, True),     # rep 64: one position a tile
    (2, 300, 4, 4, 80, None, True),    # hd 80, rep 1
    (2, 300, 4, 4, 80, 30, False),     # hd 80, window: one segment each
    (1, 520, 8, 2, 120, None, True),   # hd 120, rep 4
    (1, 4608, 32, 8, 120, 4096, True),  # h2o-danube-3-4b, window binds
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window,split", DKV_SHAPES)
def test_flash_bwd_dkv_builds_and_schedules_match_plain(
        cuda_device, B, S, H, KV, hd, window, split):
    """K8c at each head dim, with one segment a key tile and with many,
    against the plain backward within 1e-4 of each gradient's largest
    element, and bitwise equal when run again."""
    rng = np.random.default_rng(S + H + hd)
    q = _randn(rng, (B, S, H, hd), cuda_device)
    k = _randn(rng, (B, S, KV, hd), cuda_device)
    v = _randn(rng, (B, S, KV, hd), cuda_device)
    do = _randn(rng, (B, S, H, hd), cuda_device)
    o, lse = tfa.flash_fwd_plain(q, k, v, window=window)
    _, want_k, want_v = tfa.flash_bwd_plain(q, k, v, o, lse, do,
                                            window=window)
    dcap = tfa.flash_dcap(do, o, KV)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tfa.dkv_plan(B, S, H, KV, hd, True, window, n_sm=n_sm)
    assert (plan.max_ns > 1) == split
    kw = dict(window=window)
    before = tfa.flash_bwd_dkv_cuda.launches
    dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw)
    again = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dkv_cuda.launches == before + 2
    for got, ref in zip((dk, dv), (want_k, want_v)):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


DQ_SHAPES = [                    # B, S, H, KV, hd, window, split
    (4, 1024, 4, 1, 256, 512, True),   # gemma3 local: a ragged last wave
    (4, 1024, 4, 1, 256, None, False),  # gemma3 global: longest first
    (2, 300, 9, 3, 64, None, True),    # smollm's heads, 64-key tiles
    (2, 130, 8, 4, 128, 40, True),     # window ends mid-tile
    (2, 300, 4, 4, 80, 30, True),      # hd 80, rep 1, window
    (4, 1024, 32, 32, 80, None, False),  # stablelm-3b: longest first
    (1, 1000, 8, 2, 120, None, True),  # hd 120, rep 4, ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window,split", DQ_SHAPES)
def test_flash_bwd_dq_schedules_match_plain(cuda_device, B, S, H, KV, hd,
                                           window, split):
    """K8b with its query tiles whole and split into segments, against the
    plain backward within 1e-4 of dq's largest element, and bitwise equal
    when run again."""
    rng = np.random.default_rng(S + H + hd)
    q = _randn(rng, (B, S, H, hd), cuda_device)
    k = _randn(rng, (B, S, KV, hd), cuda_device)
    v = _randn(rng, (B, S, KV, hd), cuda_device)
    do = _randn(rng, (B, S, H, hd), cuda_device)
    o, lse = tfa.flash_fwd_plain(q, k, v, window=window)
    want = tfa.flash_bwd_plain(q, k, v, o, lse, do, window=window)[0]
    dcap = tfa.flash_dcap(do, o, KV)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tfa.dq_plan(B, S, H, KV, hd, True, window, n_sm=n_sm)
    assert (plan.max_ns > 1) == split
    before = tfa.flash_bwd_dq_cuda.launches
    dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, window=window)
    again = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dq_cuda.launches == before + 2
    assert (dq - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(dq, again)


@pytest.mark.cuda
def test_flash_attention_backward_on_the_card_matches_the_cpu(cuda_device):
    """The autograd.Function's gradients on the card (K8a, K8b, K8c)
    against the same function on the CPU (plain versions)."""
    rng = np.random.default_rng(5)
    shapes = [(2, 70, 9, 64), (2, 70, 3, 64), (2, 70, 3, 64)]
    base = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    do = rng.standard_normal(shapes[0]).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        x = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in base]
        o = tfa.make_flash_attention(window=24)(*x)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            o, x, torch.from_numpy(do).to(dev))]
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,hd,valid", [
    (4, 1056, 4, 1, 256, 1), (4, 1056, 4, 1, 256, 600),
    (4, 1056, 4, 1, 256, 1056),         # gemma3's global cache
    (4, 512, 4, 1, 256, 512),           # gemma3's full local ring
    (2, 100, 9, 3, 64, 37),             # smollm's heads (rep 3)
    (4, 1056, 9, 3, 64, 1), (4, 1056, 9, 3, 64, 1056),
    (1, 40, 8, 8, 128, 40),             # rep 1
    (2, 300, 8, 8, 64, 1), (2, 300, 8, 8, 64, 150),
    (2, 300, 8, 1, 128, 1), (2, 300, 8, 1, 128, 151),      # rep 8
    (2, 300, 8, 1, 128, 300),
    (4, 1056, 16, 1, 256, 1), (4, 1056, 16, 1, 256, 529),  # rep 16
    (4, 1056, 16, 1, 256, 1056),
    # hd 80 (stablelm-3b's cache, rep 1) and hd 120 (h2o-danube-3-4b's
    # heads, rep 4, its full ring and a cache of 1,056)
    (4, 1056, 32, 32, 80, 1), (4, 1056, 32, 32, 80, 1025),
    (4, 1056, 32, 32, 80, 1056), (2, 300, 8, 8, 80, 150),
    (1, 4096, 32, 8, 120, 4096), (1, 1056, 32, 8, 120, 529),
    (1, 1056, 32, 8, 120, 1056),
])
def test_flash_decode_kernel_matches_plain(cuda_device, B, L, H, KV, hd,
                                           valid):
    rng = np.random.default_rng(L + valid)
    q = _randn(rng, (B, 1, H, hd), cuda_device)
    k = _randn(rng, (B, L, KV, hd), cuda_device)
    v = _randn(rng, (B, L, KV, hd), cuda_device)
    vl = torch.tensor([valid], dtype=torch.int32, device=cuda_device)
    before = tda.flash_decode_cuda.launches
    got = tda.flash_decode_cuda(q, k, v, vl)
    want = tda.flash_decode_plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert tda.flash_decode_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert torch.equal(got, tda.flash_decode_cuda(q, k, v, vl))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 7])
@pytest.mark.parametrize("valid", [1, 99, 300])
def test_flash_decode_kernel_merges_many_slices(cuda_device, split, valid):
    """A slice length far below the plan's (up to 300 slices a group, so
    the last block merges them in several windows of weights), with the
    valid length as an int64 on the card, a Python int and None."""
    rng = np.random.default_rng(split + valid)
    q = _randn(rng, (2, 1, 16, 64), cuda_device)
    k = _randn(rng, (2, 300, 1, 64), cuda_device)
    v = _randn(rng, (2, 300, 1, 64), cuda_device)
    want = tda.flash_decode_plain(q, k, v, valid)
    for vl in (torch.tensor(valid, device=cuda_device), valid):
        got = tda.flash_decode_cuda(q, k, v, vl, split=split)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    if valid == 300:
        torch.testing.assert_close(
            tda.flash_decode_cuda(q, k, v, None, split=split), want,
            atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,hd", [(4, 528, 4, 1, 256),
                                         (4, 256, 4, 1, 256),
                                         (4, 528, 32, 32, 80),
                                         (2, 300, 16, 1, 64)])
@pytest.mark.parametrize("valid", [0, 1, 199, "all"])
def test_flash_decode_lse_matches_plain(cuda_device, B, L, H, KV, hd,
                                        valid):
    """K9's log-sum-exp at a rank's slice of gemma3-1b's global cache
    (1,056 in two) and ring (512 in two), stablelm-3b's, and a slice
    merged over several windows: o and lse against the plain version, o
    bit-equal to the call without lse.  An empty slice (valid 0) gives a
    finite o and lse = -1e30, whose merge weight is 0."""
    valid = L if valid == "all" else valid
    rng = np.random.default_rng(L + valid + hd)
    q = _randn(rng, (B, 1, H, hd), cuda_device)
    k = _randn(rng, (B, L, KV, hd), cuda_device)
    v = _randn(rng, (B, L, KV, hd), cuda_device)
    vl = torch.tensor(valid, device=cuda_device)
    split = 7 if L == 300 else None
    before = tda.flash_decode_cuda.launches
    o, lse = tda.flash_decode_cuda(q, k, v, vl, want_lse=True, split=split)
    torch.cuda.synchronize()
    assert tda.flash_decode_cuda.launches == before + 1
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert torch.equal(o, tda.flash_decode_cuda(q, k, v, vl, split=split))
    want_o, want_lse = tda.flash_decode_plain(q, k, v, valid, want_lse=True)
    if valid == 0:
        assert (lse == -1e30).all() and (o == 0).all()
        assert (want_lse < -1e29).all()
        return
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("valid", [1, 300, 1056])
def test_flash_decode_slices_merge_to_the_whole(cuda_device, n, valid):
    """gemma3-1b's global cache cut into ``n`` slices, each attended by K9
    up to ``clamp(valid - offset, 0, L_loc)`` with its lse, merged: equal
    to one K9 call over the whole cache (empty slices included)."""
    B, L, H, KV, hd = 4, 1056, 4, 1, 256
    rng = np.random.default_rng(valid + n)
    q = _randn(rng, (B, 1, H, hd), cuda_device)
    k = _randn(rng, (B, L, KV, hd), cuda_device)
    v = _randn(rng, (B, L, KV, hd), cuda_device)
    whole = tda.flash_decode_cuda(q, k, v, valid)
    L_loc = L // n
    parts = [tda.flash_decode_cuda(
        q, k[:, r * L_loc:(r + 1) * L_loc].contiguous(),
        v[:, r * L_loc:(r + 1) * L_loc].contiguous(),
        torch.tensor(max(0, min(valid - r * L_loc, L_loc)),
                     device=cuda_device), want_lse=True) for r in range(n)]
    got = tda.merge_partials(torch.stack([o for o, _ in parts]),
                             torch.stack([x for _, x in parts]))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,m", [(8192, 576, 2), (490, 64, 2),
                                   (4096, 2560, 2), (33, 30, 2),
                                   (8192, 576, 16)])
def test_fusion_conv_kernel_takes_a_column_block(cuda_device, T, C, m):
    """K2 on a tensor-parallel rank's column block of W [2C, C/m]
    (smollm-135m's fusion at m = 2: N = 288; stablelm-3b's; N % 4 != 0 on
    the scalar path), against the plain version and the whole operator's
    columns."""
    fg, fl, w = (torch.from_numpy(a).to(cuda_device)
                 for a in fusion_inputs((T,), C, T + C + m))
    N = C // m
    block = w[:, N:2 * N].contiguous()
    got = tfc.fusion_conv_cuda(fg, fl, block)
    assert got.shape == (T, N)
    want = tfc.fusion_conv_plain(fg, fl, block)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    full = tfc.fusion_conv_cuda(fg, fl, w)
    torch.testing.assert_close(got, full[:, N:2 * N], rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_flash_decode_replays_in_a_cuda_graph(cuda_device):
    """One K9 call captured once and replayed at two valid lengths set on
    the card: each replay equals the plain version, bitwise equal to an
    eager call, and the self-resetting tickets stay zero."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (4, 1, 4, 256), cuda_device)
    k = _randn(rng, (4, 1056, 1, 256), cuda_device)
    v = _randn(rng, (4, 1056, 1, 256), cuda_device)
    valid = torch.tensor(1, device=cuda_device)
    tda.flash_decode_cuda(q, k, v, valid)            # tickets made outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tda.flash_decode_cuda(q, k, v, valid)
    for n in (1056, 529, 1056):
        valid.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, tda.flash_decode_plain(q, k, v, n),
                                   atol=1e-5, rtol=1e-4)
        assert torch.equal(out, tda.flash_decode_cuda(q, k, v, valid))
    assert not tda._tickets(cuda_device, 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_layer_replays_in_a_cuda_graph(cuda_device, hd):
    """One windowed attention layer, forward (K8a) and backward (K8b +
    K8c through the autograd Function), captured once as a CUDA graph (the
    LM engine's local steps run it so) and replayed on two inputs copied
    into its static buffers: every output equals an eager call on the same
    inputs bit for bit, and the kernels' counters tick at capture only."""
    B, S, H, KV, window = 2, 320, 4, 2, 96
    flash = tfa.make_flash_attention(causal=True, window=window)
    rng = np.random.default_rng(hd)
    static = [_randn(rng, shape, cuda_device) for shape in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]

    def layer(q, k, v, do):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash(q, k, v)
        return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            layer(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = layer(*static)
    for seed in (1, 2):
        rng = np.random.default_rng(100 * hd + seed)
        fresh = [_randn(rng, tuple(t.shape), cuda_device) for t in static]
        for t, f in zip(static, fresh):
            t.copy_(f)
        before = _attn_launches() + _bwd_launches()
        graph.replay()
        torch.cuda.synchronize()
        assert _attn_launches() + _bwd_launches() == before
        for got, want in zip(outs, layer(*fresh)):
            assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,up,store", [
    ("fedavg", "identity", "device"), ("fedfusion", "topk", "host")])
def test_lm_engine_graph_replay_matches_reference(cuda_device, algorithm,
                                                  up, store):
    """A reduced LM (smollm-135m, 2 layers, vocab 256, K8a-K8c) through
    the engine, each 2-round chunk a graph replay, against the reference
    loop's eager rounds on the card: every leaf and the history equal."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.data import (FederatedDataset, source_partition,
                                  token_stream)
    from repro_torch.fl.server import run_federated, run_federated_reference
    from repro_torch.models import make_bundle
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              attn_impl="pallas", vocab_size=256)
    bundle = make_bundle(cfg)
    toks, src = token_stream(96, 64, vocab=256, n_sources=4, seed=0)
    test, _ = token_stream(8, 64, vocab=256, n_sources=4, seed=1)

    def data():
        return FederatedDataset(source_partition(toks, src, 4),
                                {"tokens": test}, seed=0)

    fl = FLConfig(algorithm=algorithm, fusion_op="conv", clients_per_round=2,
                  local_steps=2, local_batch=4, lr=0.02, uplink_codec=up,
                  topk_frac=1 / 16)
    kw = dict(rounds=4, eval_every=2, eval_examples=8, device=cuda_device)
    ref = run_federated_reference(bundle, fl, data(), **kw)
    before = _attn_launches() + _bwd_launches()
    eng = run_federated(bundle, fl, data(), superstep_rounds=2,
                        ef_store=store, **kw)
    torch.cuda.synchronize()
    graphs = eng.stats["graphs"]
    assert eng.stats["cuda_graphs"] and len(graphs) == 1
    assert graphs[0]["rounds"] == 2 and graphs[0]["replays"] == 2
    # K8a a layer a forward (twice for FedFusion's two streams), K8b and
    # K8c a layer a backward: 2 rounds x 2 clients x 2 steps a replay,
    # counted in the two warm-up runs and the capture; the two boundary
    # evals run K8a eagerly, once a layer
    layers, steps = 2, 2 * 2 * 2
    fwd = layers * steps * (2 if algorithm == "fedfusion" else 1)
    d = [g - b for g, b in zip(_attn_launches() + _bwd_launches(), before)]
    assert (d[0], d[2], d[3]) == (3 * fwd + 2 * layers,
                                  3 * layers * steps, 3 * layers * steps)
    for a, b in zip(tree_leaves(eng.global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b), (a - b).abs().max().item()
    assert eng.comm.history == ref.comm.history


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80, 120])
def test_attention_kernels_never_take_the_plain_path_on_the_card(
        cuda_device, monkeypatch, hd):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_fwd_plain", refuse)
    monkeypatch.setattr(tfa, "flash_bwd_plain", refuse)
    monkeypatch.setattr(tda, "flash_decode_plain", refuse)
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 16, 4, hd), cuda_device).requires_grad_(True)
    kv = _randn(rng, (1, 16, 1, hd), cuda_device).requires_grad_(True)
    before = _attn_launches() + _bwd_launches()
    o = tfa.make_flash_attention(window=8)(q, kv, kv)
    torch.autograd.grad(o.sum(), (q, kv))
    tops.gqa_flash_decode(q[:, :1].detach(), kv.detach(), kv.detach(), 5)
    torch.cuda.synchronize()
    assert _attn_launches() + _bwd_launches() == tuple(
        n + 1 for n in before)


@pytest.mark.cuda
def test_attention_wrappers_refuse_bad_inputs(cuda_device):
    z = torch.zeros
    kw = dict(device=cuda_device)
    valid = torch.tensor([1], dtype=torch.int32, **kw)
    with pytest.raises(ValueError, match="shapes"):       # hd 32
        tfa.flash_fwd_cuda(z(1, 8, 2, 32, **kw), z(1, 8, 1, 32, **kw),
                           z(1, 8, 1, 32, **kw))
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_fwd_cuda(z(1, 8, 2, 64, dtype=torch.float64, **kw),
                           z(1, 8, 1, 64, **kw), z(1, 8, 1, 64, **kw))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd_cuda(z(1, 2, 8, 64, **kw).transpose(1, 2),
                           z(1, 8, 1, 64, **kw), z(1, 8, 1, 64, **kw))
    flat = z(1 + 8 * 2 * 64, **kw)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_fwd_cuda(flat[1:].view(1, 8, 2, 64), z(1, 8, 1, 64, **kw),
                           z(1, 8, 1, 64, **kw))
    with pytest.raises(ValueError, match="shapes"):       # hd 32
        tda.flash_decode_cuda(z(1, 1, 16, 32, **kw), z(1, 8, 1, 32, **kw),
                              z(1, 8, 1, 32, **kw), valid)
    # hd 96: a multiple of 4 no config uses, so no kernel is built for it
    with pytest.raises(ValueError, match="no kernel is built"):
        tfa.flash_fwd_cuda(z(1, 8, 2, 96, **kw), z(1, 8, 1, 96, **kw),
                           z(1, 8, 1, 96, **kw))
    with pytest.raises(ValueError, match="head dims K9 is built for"):
        tda.flash_decode_cuda(z(1, 1, 4, 96, **kw), z(1, 8, 1, 96, **kw),
                              z(1, 8, 1, 96, **kw), valid)
    with pytest.raises(ValueError, match="shapes"):       # H % KV
        tda.flash_decode_cuda(z(1, 1, 5, 64, **kw), z(1, 8, 2, 64, **kw),
                              z(1, 8, 2, 64, **kw), valid)
    with pytest.raises(ValueError, match="int32 or int64"):
        tda.flash_decode_cuda(z(1, 1, 4, 64, **kw), z(1, 8, 1, 64, **kw),
                              z(1, 8, 1, 64, **kw), valid.float())
    with pytest.raises(ValueError, match="aligned"):
        tda.flash_decode_cuda(z(1 + 4 * 64, **kw)[1:].view(1, 1, 4, 64),
                              z(1, 8, 1, 64, **kw), z(1, 8, 1, 64, **kw),
                              valid)
    # the backward's wrappers take K8a's contract, and lse / D [B,KV,rep,S]
    q, kv, lse = z(1, 8, 2, 64, **kw), z(1, 8, 1, 64, **kw), z(1, 1, 2, 8, **kw)
    for fn in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="shapes"):
            fn(q, kv, kv, q, z(1, 1, 2, 7, **kw), lse)
        with pytest.raises(ValueError, match="shapes"):
            fn(q, kv, kv, z(1, 7, 2, 64, **kw), lse, lse)
        with pytest.raises(ValueError, match="float32"):
            fn(q, kv, kv, q, lse, lse.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, kv, kv, z(1, 2, 8, 64, **kw).transpose(1, 2), lse, lse)
        with pytest.raises(ValueError, match="aligned"):
            fn(q, kv, kv, flat[1:].view(1, 8, 2, 64), lse, lse)
        with pytest.raises(ValueError, match="window"):
            fn(q, kv, kv, q, lse, lse, window=0)


@pytest.mark.cuda
def test_init_global_state_draws_on_a_card_generator(cuda_device):
    """A CUDA generator draws the LM weights and FedFusion's conv fusion
    weights on the card (W = 0.5 [I; I] plus noise, built there too)."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import init_global_state
    from repro_torch.models import make_bundle
    cfg = get_config("gemma3-1b").reduced()
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = init_global_state(make_bundle(cfg), fl, gen, device=cuda_device)
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    w, d = state["fusion"]["w"], cfg.d_model
    eye = torch.eye(d, device=cuda_device)
    assert (w[:d] - 0.5 * eye).abs().max() < 0.1
    assert (w[d:] - 0.5 * eye).abs().max() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "smollm-135m"])
def test_lm_local_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One FedFusion-conv local step of the reduced LM (S = 80, longer
    than gemma3's reduced window) on the card (K8a for both streams, K8b,
    K8c, K2) and on the CPU from the same state: the trained parameters
    agree within 1% of the change the step made (largest element), and
    the kernels launch once per attention layer per forward / backward."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import init_global_state, make_local_trainer
    from repro_torch.fl.api import make_algorithm
    from repro_torch.models import make_bundle
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="pallas")
    bundle = make_bundle(cfg)
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv", local_steps=1)
    state = init_global_state(bundle, fl, torch.Generator().manual_seed(1),
                              device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2, 81)))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    before = _attn_launches()[0], *_bwd_launches()
    for dev in ("cpu", cuda_device):
        st = tree_map(lambda t, dev=dev: t.to(dev), state)
        b = {k: v.to(dev) for k, v in batch.items()}
        trainable, loss = make_local_trainer(bundle, fl)(
            st["model"], make_algorithm("fedfusion").extra_from_state(st),
            b, 0.05)
        out[str(dev)] = torch.cat([t.cpu().flatten()
                                   for t in tree_leaves(trainable)])
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (_attn_launches()[0], *_bwd_launches()) == (
        before[0] + 2 * L, before[1] + L, before[2] + L)
    start = torch.cat([t.flatten() for t in tree_leaves(
        {"model": state["model"], "fusion": state["fusion"]})])
    change = (out["cpu"] - start).abs().max()
    assert (out[str(cuda_device)] - out["cpu"]).abs().max() <= 1e-2 * change


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "smollm-135m"])
def test_serve_runs_on_the_card(cuda_device, arch, capsys):
    """launch.serve at reduced size, 2 decode steps: K8a once per layer
    per prefill, K9 once per layer per decode step, and the card's tokens
    equal the CPU's from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    before = _attn_launches()
    serve.main(["--arch", arch, "--prompt-len", "80", "--gen-len", "2",
                "--batch", "2"])
    assert "decode 2 tokens" in capsys.readouterr().out
    n_layers = get_config(arch).reduced().n_layers
    assert _attn_launches() == (before[0] + n_layers,
                                before[1] + 2 * n_layers)
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="pallas")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    tokens = serve.make_prompts(cfg, 2, 80, device="cpu")
    got = {}
    with torch.no_grad():
        for dev in ("cpu", cuda_device):
            p = tree_map(lambda t, dev=dev: t.to(dev), params)
            last, cache = serve.prefill(cfg, p, tokens.to(dev), 82)
            toks, logits, _ = serve.greedy_decode(cfg, p, cache, last, 80, 2)
            got[str(dev)] = (toks.cpu(), logits.cpu())
    cpu, card = got["cpu"], got[str(cuda_device)]
    assert torch.equal(cpu[0], card[0])
    torch.testing.assert_close(card[1], cpu[1], atol=1e-3, rtol=1e-3)


# --------------------------------------------------------------------------
# the decode step captured once as a CUDA graph (launch.serve.DecodeGraph)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-1b-a400m"])
def test_decode_graph_equals_eager_decode_bit_for_bit(cuda_device, name):
    """Two requests through one captured decode step (the second's cache
    copied into the captured tensors) against ``greedy_decode``'s eager
    steps: the same tokens and the same logits, bit for bit; K9 once a
    layer a replay, counted at the capture only."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(name).reduced(), attn_impl="pallas")
    params = tfm.init_params(cfg, torch.Generator(device=cuda_device)
                             .manual_seed(0), device=cuda_device)
    P, G = 80, 6
    loop = serve.DecodeGraph(
        lambda p, t, c, pos: tfm.decode_step(cfg, p, t, c, pos), params, G)
    with torch.no_grad():
        for seed in (0, 1):
            tokens = serve.make_prompts(cfg, 2, P, seed=seed,
                                        device=cuda_device)
            last, cache = serve.prefill(cfg, params, tokens, P + G)
            want = serve.greedy_decode(cfg, params,
                                       tree_map(torch.clone, cache), last,
                                       P, G)
            k9 = tda.flash_decode_cuda.launches
            got = loop.run(last, cache, P)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert tda.flash_decode_cuda.launches - k9 == (
                2 * cfg.n_layers if seed == 0 else 0)
    assert loop.replays == 2 * G
    assert loop.stats["launches_per_replay"] == {
        "flash_decode": cfg.n_layers}


@pytest.mark.cuda
def test_decode_graph_capture_on_a_gloo_mesh_raises(cuda_device):
    """A gloo mesh's collectives wait on the host: the capture is refused
    before anything runs (a one-rank gloo group made for the test)."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized(), "a process group is already set up"
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        with pytest.raises(ValueError, match="gloo"):
            serve.DecodeGraph(None, {}, 4, graph=True, mesh=mesh)
        assert serve.decode_mode(cuda_device, mesh) == "eager (gloo)"
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the client-sharded engine on one rank: NCCL all-reduces inside a captured
# graph (a one-card host shows only the one-rank case; S > 1 is held on
# the CPU over gloo, tests/test_torch_sharded.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_group():
    """A one-rank NCCL group (over a default group made on an in-process
    store when the process has none, destroyed afterwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield dist.new_group(ranks=[0], backend="nccl")
    if made:
        dist.destroy_process_group()


def _nccl_shard(group):
    from repro_torch.core.aggregate import ClientSharding
    return ClientSharding(("data",), (1,), group=group, position=0)


@pytest.mark.cuda
def test_fused_psum_replays_in_a_cuda_graph_over_nccl(cuda_device,
                                                       nccl_group):
    from repro_torch.core.aggregate import fused_psum
    shard = _nccl_shard(nccl_group)
    tree = {"a": torch.randn(5, 3, device=cuda_device),
            "b": [torch.randn(7, device=cuda_device),
                  torch.randn((), device=cuda_device)]}
    want = tree_map(torch.clone, tree)
    # eager first: creates the communicator outside the capture
    eager = fused_psum(tree, shard)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_psum(tree, shard)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = shard.collectives
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fused_psum(tree, shard)
    assert shard.collectives == before + 1
    for step in range(2):
        for t in tree_leaves(tree):
            t.mul_(2.0)
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(tree_leaves(out), tree_leaves(want)):
            assert torch.equal(o, w * 2.0 ** (step + 1))
    assert shard.collectives == before + 1       # replays issue nothing
    for o, w in zip(tree_leaves(eager), tree_leaves(want)):
        assert torch.equal(o, w)


@pytest.mark.cuda
def test_one_rank_fused_compressed_superstep_replays_in_a_graph(cuda_device,
                                                                nccl_group):
    """The shard-aware fused compressed superstep over one NCCL rank,
    captured by the engine and replayed, within 2e-5 of the single-device
    superstep; K + 1 all-reduces a replay, K6 K + 1 times and K7 K times
    an EF leaf."""
    from repro_torch.configs import FLConfig
    from repro_torch.engine import run_federated_engine
    bundle, data = _small_engine_setup()
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  clients_per_round=3, local_steps=2, local_batch=4,
                  uplink_codec="topk", topk_frac=1 / 16)
    shard = _nccl_shard(nccl_group)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kw = dict(rounds=4, eval_examples=32, superstep_rounds=2,
                  device=cuda_device)
        single = run_federated_engine(bundle, fl, data(), **kw)
        sharded = run_federated_engine(bundle, fl, data(), shard=shard,
                                       sharded_eval=False, **kw)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    graphs = sharded.stats["graphs"]
    assert len(graphs) == 1 and graphs[0]["replays"] == 2
    assert graphs[0]["collectives_per_replay"] == 2 + 1
    per = graphs[0]["launches_per_replay"]
    assert (per["ef_gather"], per["ef_scatter"]) == (8 * 3, 8 * 2)
    for a, b in zip(tree_leaves(sharded.global_state),
                    tree_leaves(single.global_state)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    assert (sharded.comm.bytes_up, sharded.comm.bytes_down) == \
        (single.comm.bytes_up, single.comm.bytes_down)


def test_make_engine_mesh_needs_a_card_or_the_cpu():
    """Without a card and without ``device="cpu"`` the mesh is refused,
    as the entry points refuse a silent CPU fall-back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh exists")
    from repro_torch.launch.mesh import make_engine_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine_mesh()


# --------------------------------------------------------------------------
# the recurrent families (SSD, RG-LRU) and remat on the card
# --------------------------------------------------------------------------

RECURRENT = ["mamba2-130m", "recurrentgemma-9b"]


def _recurrent_cfg(name, **changes):
    """The reduced config, K8a-K8c / K9 on; recurrentgemma-9b at five
    layers (a cycle of RG-LRU, RG-LRU, local attention and a tail of two
    RG-LRU) with a window of 16."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import hybrid_pattern
    if name == "recurrentgemma-9b":
        changes = dict(dict(n_layers=5, block_pattern=hybrid_pattern(5),
                            sliding_window=16), **changes)
    return dataclasses.replace(get_config(name).reduced(),
                               attn_impl="pallas", **changes)


def _close_to_scale(got, want, rtol=1e-4, scale=1e-4):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=scale * max(want.abs().max().item(),
                                                1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_families_on_the_card_match_the_cpu(cuda_device, name):
    """The same weights and tokens on the card and the CPU: the logits of
    24 positions (past recurrentgemma's window of 16) and the gradients of
    sum(logits * g), then a prefill and 4 decode steps (the states, conv
    windows and K/V rings after them): rtol 1e-4 with an atol of 1e-4 of
    each tensor's scale."""
    from repro_torch.models import transformer as tfm
    cfg = _recurrent_cfg(name)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 28)))
    g = torch.from_numpy(rng.standard_normal(
        (2, 24, cfg.vocab_size)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t, dev=dev: t.detach().to(dev).requires_grad_(True),
                     params)
        lg = tfm.forward_seq(cfg, p, {"tokens": tokens[:, :24].to(dev)})[
            "logits"]
        (lg * g.to(dev)).sum().backward()
        with torch.no_grad():
            pre = tfm.forward_seq(cfg, p, {"tokens": tokens[:, :24].to(dev)},
                                  want_cache=True, max_cache_len=28)
            cache, steps = pre["cache"], []
            for i in range(4):
                step, cache = tfm.decode_step(
                    cfg, p, tokens[:, 24 + i:25 + i].to(dev), cache, 24 + i)
                steps.append(step.cpu())
        out[str(dev)] = ([lg.detach().cpu()]
                         + [t.grad.cpu() for t in tree_leaves(p)] + steps
                         + [t.cpu() for t in tree_leaves(cache)])
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        _close_to_scale(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", RECURRENT)
def test_decode_graph_equals_eager_decode_for_recurrent_caches(cuda_device,
                                                               name):
    """Two requests through one captured decode step against
    ``greedy_decode``'s eager steps, bit for bit: the second request's SSD
    / RG-LRU states and conv windows are copied into the captured cache
    tensors with its K/V ring; K9 once an attention layer a replay."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = _recurrent_cfg(name)
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
    params = tfm.init_params(cfg, torch.Generator(device=cuda_device)
                             .manual_seed(0), device=cuda_device)
    P, G = 40, 6
    loop = serve.DecodeGraph(
        lambda p, t, c, pos: tfm.decode_step(cfg, p, t, c, pos), params, G)
    with torch.no_grad():
        for seed in (0, 1):
            tokens = serve.make_prompts(cfg, 2, P, seed=seed,
                                        device=cuda_device)
            last, cache = serve.prefill(cfg, params, tokens, P + G)
            want = serve.greedy_decode(cfg, params,
                                       tree_map(torch.clone, cache), last,
                                       P, G)
            got = loop.run(last, cache, P)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert loop.replays == 2 * G
    assert loop.stats["launches_per_replay"] == {"flash_decode": n_attn}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-9b"])
def test_remat_layer_replays_in_a_cuda_graph(cuda_device, name):
    """``remat="layer"`` through the LM engine (each 2-round chunk a
    graph replay, the cycles' recomputation captured) against the
    reference loop's eager rounds with it: every leaf and the history
    equal; K8a once more per checkpointed attention layer a step."""
    from repro_torch.configs import FLConfig
    from repro_torch.data import (FederatedDataset, source_partition,
                                  token_stream)
    from repro_torch.fl.server import run_federated, run_federated_reference
    from repro_torch.models import make_bundle
    from repro_torch.configs import get_config
    cfg = (_recurrent_cfg(name, vocab_size=256, remat="layer")
           if name in RECURRENT else dataclasses.replace(
               get_config(name).reduced(), attn_impl="pallas",
               vocab_size=256, remat="layer"))
    bundle = make_bundle(cfg)
    toks, src = token_stream(96, 32, vocab=256, n_sources=4, seed=0)
    test, _ = token_stream(8, 32, vocab=256, n_sources=4, seed=1)

    def data():
        return FederatedDataset(source_partition(toks, src, 4),
                                {"tokens": test}, seed=0)

    fl = FLConfig(algorithm="fedavg", clients_per_round=2, local_steps=2,
                  local_batch=4, lr=0.02)
    kw = dict(rounds=4, eval_every=4, eval_examples=8, device=cuda_device)
    ref = run_federated_reference(bundle, fl, data(), **kw)
    before = _attn_launches()[0]
    eng = run_federated(bundle, fl, data(), superstep_rounds=2, **kw)
    torch.cuda.synchronize()
    graphs = eng.stats["graphs"]
    assert eng.stats["cuda_graphs"] and graphs[0]["replays"] == 2
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
    in_cycles = sum(k.startswith("attn") for k in cfg.block_pattern[:3]) \
        if name in RECURRENT else n_attn
    # 2 rounds x 2 clients x 2 steps a replay, in two warm-ups and the
    # capture: K8a per attention layer and once more per checkpointed
    # one; the final eval eagerly
    assert _attn_launches()[0] - before == \
        3 * 8 * (n_attn + in_cycles) + n_attn
    for a, b in zip(tree_leaves(eng.global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b), (a - b).abs().max().item()
    assert eng.comm.history == ref.comm.history


@pytest.mark.cuda
def test_attention_kernels_at_recurrentgemma_local_shapes(cuda_device):
    """recurrentgemma-9b's local layers (16 query heads over one KV head
    of 256, window 2,048): K8a at a prompt of 2,560 (the window binds),
    K8b / K8c at a client's training batch (2 x 1,024), K9 on the full
    2,048 ring, each against its plain version."""
    rng = np.random.default_rng(6)
    q, k, v = (_randn(rng, (1, 2560, h, 256), cuda_device)
               for h in (16, 1, 1))
    o, lse = tfa.flash_fwd_cuda(q, k, v, window=2048)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, window=2048)
    torch.testing.assert_close(o, o_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-4)
    x = [_randn(rng, (2, 1024, h, 256), cuda_device) for h in (16, 1, 1)]
    do = _randn(rng, (2, 1024, 16, 256), cuda_device)
    grads = []
    for fn in (tfa.make_flash_attention(window=2048),
               lambda *a: tfa.flash_fwd_plain(*a, window=2048)[0]):
        xs = [t.clone().requires_grad_(True) for t in x]
        grads.append(torch.autograd.grad(fn(*xs), xs, do))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item())
    qd = _randn(rng, (1, 1, 16, 256), cuda_device)
    kc, vc = (_randn(rng, (1, 2048, 1, 256), cuda_device) for _ in "kv")
    valid = torch.tensor(2048, device=cuda_device)
    torch.testing.assert_close(
        tda.flash_decode_cuda(qd, kc, vc, valid),
        tda.flash_decode_plain(qd, kc, vc, valid), atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# the encoder-decoder (whisper-large-v3) and VLM (qwen2-vl-7b) families
# --------------------------------------------------------------------------

MULTIMODAL = ["whisper-large-v3", "qwen2-vl-7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 100, 4, 4, 64, False),          # ragged, rep 1, no causal mask
    (1, 1500, 20, 20, 64, False),       # whisper's encoder: 23 x 64 + 28
    (2, 100, 28, 4, 128, False),        # qwen2-vl's heads: rep 7, hd 128
    (2, 100, 28, 4, 128, True),
])
def test_flash_kernels_at_the_new_modes_match_plain(cuda_device, B, S, H,
                                                    KV, hd, causal):
    """K8a, K8b and K8c with and without the causal mask at the slice's
    shapes against their plain versions, each launched once, and bitwise
    equal when run again."""
    rng = np.random.default_rng(S + H + hd + causal)
    q = _randn(rng, (B, S, H, hd), cuda_device)
    k = _randn(rng, (B, S, KV, hd), cuda_device)
    v = _randn(rng, (B, S, KV, hd), cuda_device)
    do = _randn(rng, (B, S, H, hd), cuda_device)
    kw = dict(causal=causal)
    before = _attn_launches()[0], _bwd_launches()
    o, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-4)
    want = tfa.flash_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    dcap = tfa.flash_dcap(do, o, KV)
    dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, **kw)
    dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw)
    torch.cuda.synchronize()
    assert (_attn_launches()[0], _bwd_launches()) == (
        before[0] + 1, (before[1][0] + 1, before[1][1] + 1))
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item())
    again = (tfa.flash_fwd_cuda(q, k, v, **kw),
             tfa.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, **kw),
             tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw))
    assert torch.equal(again[0][0], o) and torch.equal(again[0][1], lse)
    assert torch.equal(again[1], dq)
    assert torch.equal(again[2][0], dk) and torch.equal(again[2][1], dv)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,hd,valid", [
    (4, 1500, 20, 20, 64, None),        # whisper's cross cache, all valid
    (2, 1500, 4, 4, 64, None),
    (4, 1056, 28, 4, 128, 1025),        # qwen2-vl's self cache, rep 7
    (4, 1056, 28, 4, 128, None),
])
def test_flash_decode_over_a_whole_cache_matches_plain(cuda_device, B, L, H,
                                                       KV, hd, valid):
    """K9 with no valid length (every position, the cross cache) and at
    qwen2-vl-7b's heads, against the plain version."""
    rng = np.random.default_rng(L + H)
    q = _randn(rng, (B, 1, H, hd), cuda_device)
    k = _randn(rng, (B, L, KV, hd), cuda_device)
    v = _randn(rng, (B, L, KV, hd), cuda_device)
    vl = None if valid is None else torch.tensor(valid, device=cuda_device)
    before = tda.flash_decode_cuda.launches
    got = tda.flash_decode_cuda(q, k, v, vl)
    torch.cuda.synchronize()
    assert tda.flash_decode_cuda.launches == before + 1
    torch.testing.assert_close(got, tda.flash_decode_plain(q, k, v, vl),
                               atol=1e-5, rtol=1e-4)
    assert torch.equal(got, tda.flash_decode_cuda(q, k, v, vl))


def _multimodal_inputs(cfg, B, S, rng):
    """Tokens [B, S] and the family's stub inputs (qwen2-vl: three distinct
    M-RoPE streams), seeded numpy, on the CPU."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
        batch["mrope_positions"] = torch.from_numpy(
            rng.integers(0, 2 * S, (3, B, S)))
    else:
        batch["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("name", MULTIMODAL)
def test_multimodal_families_on_the_card_match_the_cpu(cuda_device, name):
    """Reduced whisper-large-v3 and qwen2-vl-7b, the same weights and
    inputs on the card (K8a-K8c, the encoder's without the causal mask;
    K9 over the self and cross caches) and the CPU: the logits and the
    gradients of sum(logits * g), then a prefill and 4 decode steps and
    the cache after them, rtol 1e-4 with an atol of 1e-4 of each tensor's
    scale; K8a once a decoder and encoder layer a forward, K9 once a self
    and cross attention a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(name).reduced(), attn_impl="pallas")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(5)
    batch = _multimodal_inputs(cfg, 2, 28, rng)
    g = torch.from_numpy(rng.standard_normal(
        (2, 28, cfg.vocab_size)).astype(np.float32))
    stub = {k: v for k, v in batch.items() if k != "mrope_positions"}
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t, dev=dev: t.detach().to(dev).requires_grad_(True),
                     params)
        on = {k: v.to(dev) for k, v in batch.items()}
        before = _attn_launches()
        lg = tfm.forward_seq(cfg, p, on)["logits"]
        (lg * g.to(dev)).sum().backward()
        with torch.no_grad():
            pre = tfm.forward_seq(cfg, p, dict(
                {k: v.to(dev) for k, v in stub.items()},
                tokens=on["tokens"][:, :24]), want_cache=True,
                max_cache_len=28)
            cache, steps = pre["cache"], []
            for i in range(4):
                step, cache = tfm.decode_step(
                    cfg, p, on["tokens"][:, 24 + i:25 + i], cache, 24 + i)
                steps.append(step.cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            n = cfg.n_layers + cfg.n_enc_layers
            assert _attn_launches() == (
                before[0] + 2 * n,
                before[1] + 4 * cfg.n_layers * (1 + bool(cfg.n_enc_layers)))
        out[str(dev)] = ([lg.detach().cpu()]
                         + [t.grad.cpu() for t in tree_leaves(p)] + steps
                         + [t.cpu() for t in tree_leaves(cache)])
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        _close_to_scale(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MULTIMODAL)
def test_decode_graph_equals_eager_decode_with_cross_and_vision_inputs(
        cuda_device, name):
    """Two requests (their own prompts and stub inputs) through one
    captured decode step against ``greedy_decode``'s eager steps, bit for
    bit: whisper's cross cache is copied into the captured tensors with
    its self cache; K9 once a self and cross attention a replay."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(name).reduced(), attn_impl="pallas")
    params = tfm.init_params(cfg, torch.Generator(device=cuda_device)
                             .manual_seed(0), device=cuda_device)
    P, G = 40, 6
    loop = serve.DecodeGraph(
        lambda p, t, c, pos: tfm.decode_step(cfg, p, t, c, pos), params, G)
    with torch.no_grad():
        for seed in (0, 1):
            tokens = serve.make_prompts(cfg, 2, P, seed=seed,
                                        device=cuda_device)
            inputs = serve.make_inputs(cfg, 2, seed=seed, device=cuda_device)
            last, cache = serve.prefill(cfg, params, tokens, P + G, inputs)
            want = serve.greedy_decode(cfg, params,
                                       tree_map(torch.clone, cache), last,
                                       P, G)
            got = loop.run(last, cache, P)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert loop.replays == 2 * G
    assert loop.stats["launches_per_replay"] == {
        "flash_decode": cfg.n_layers * (1 + bool(cfg.n_enc_layers))}


# --------------------------------------------------------------------------
# the mesh half: K9 over a split cross cache, the recurrent layers' blocks
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_flash_decode_over_cross_cache_slices_merges_to_the_whole(
        cuda_device, n):
    """whisper-large-v3's cross cache (4 x 1,500 frames, 20 heads of 64)
    split as a (1, n) mesh splits it over ``model`` (750 frames a rank at
    n = 2, 375 at n = 4): K9 on each slice with no valid length and each
    row's log-sum-exp, merged (``merge_partials``), against K9 over the
    whole cache and the plain version (K9's tolerances); each slice's
    (o, lse) against the plain version's."""
    rng = np.random.default_rng(n)
    q = _randn(rng, (4, 1, 20, 64), cuda_device)
    k = _randn(rng, (4, 1500, 20, 64), cuda_device)
    v = _randn(rng, (4, 1500, 20, 64), cuda_device)
    before = tda.flash_decode_cuda.launches
    parts = []
    for ks, vs in zip(k.chunk(n, dim=1), v.chunk(n, dim=1)):
        assert ks.shape[1] == 1500 // n
        ks, vs = ks.contiguous(), vs.contiguous()
        o, lse = tda.flash_decode_cuda(q, ks, vs, want_lse=True)
        po, plse = tda.flash_decode_plain(q, ks, vs, want_lse=True)
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
        parts.append((o, lse))
    merged = tda.merge_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([lse for _, lse in parts]))
    whole = tda.flash_decode_cuda(q, k, v)
    torch.cuda.synchronize()
    assert tda.flash_decode_cuda.launches == before + n + 1
    torch.testing.assert_close(merged, whole, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(merged, tda.flash_decode_plain(q, k, v),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_recurrent_rank_blocks_on_the_card_match_the_whole(cuda_device,
                                                            kind):
    """The RG-LRU and SSD layers' model split (m = 2) run rank by rank on
    the card (``tests/_torch_inputs.py``: each rank's blocks and slices
    through the modules' own stages, the conv outputs or the P slices
    joined, the parts summed) against the plain whole layer on the card,
    at recurrentgemma-9b's width (W = 4,096) and mamba2-130m's (d 768,
    24 heads of 64, state 128), a batch of 2 x 256: rtol 1e-4 with an
    atol of 1e-5 of the output's scale (the parts' sum and cuBLAS at half
    the width add in other orders)."""
    from _torch_inputs import rglru_by_ranks, ssd_by_ranks
    from repro_torch.models import rglru, ssd
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if kind == "rglru":
        d = 4096
        p = rglru.rglru_init(gen, d, d)
        x = torch.randn((2, 256, d), generator=gen, device=cuda_device)
        want = rglru.rglru_apply(p, x)
        got, _ = rglru_by_ranks(p, x, 2)
    else:
        d = 768
        kw = dict(expand=2, d_state=128, head_dim=64, conv_width=4)
        p = ssd.ssd_init(gen, d, **kw)
        x = torch.randn((2, 256, d), generator=gen, device=cuda_device)
        want = ssd.ssd_apply(p, x, chunk=64, **kw)
        got = ssd_by_ranks(p, x, 2, chunk=64, **kw)
    assert got.is_cuda and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * want.abs().max().item())
