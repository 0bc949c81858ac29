"""The plain versions of the port's K1 (MK-MMD Gram sum, and the fused
MK-MMD term's forward and closed-form backward) and K2 (FedFusion conv)
against the JAX package's Pallas kernels, run in interpret mode on the CPU,
and the autograd.Functions' backward against ``jax.grad`` of the JAX
oracles.  The CUDA kernels run only on the card; ``test_torch_cuda.py``
holds them against these plain versions there.  K2's tile plan
(``fusion_conv.conv_plan``) is checked here, and the order in which its
split of K is summed is emulated in plain PyTorch and held to the Pallas
kernel at 1e-5 of the output's largest element.

Tolerances: the forward values are float32 sums of a few thousand terms
taken in another order than XLA takes them, so they agree to a few ulp of
the sum (rtol 1e-5; atol 1e-5 for outputs near zero).  Gradients are
differences of two such sums that cancel in part, so they are held to
rtol 1e-4 with an atol of 1e-6 of the gradient's own scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import WIDTHS, fusion_inputs, rng_pair

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fusion_conv import fusion_conv as j_fusion_conv
from repro.kernels.mk_mmd import gram_sum as j_gram_sum
from repro_torch.kernels import fusion_conv as tfc
from repro_torch.kernels import mk_mmd as tmk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref



# --------------------------------------------------------------------------
# plain versions on the CPU vs the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [(8, 8, 4), (10, 10, 64), (37, 53, 64),
                                   (130, 70, 16)])
def test_gram_sum_plain_matches_pallas(n, m, d):
    x, y = rng_pair(n, m, d, n * m + d)
    sigma = 3.7
    want = j_gram_sum(jnp.asarray(x), jnp.asarray(y), sigma, WIDTHS,
                      interpret=True)
    got = tmk.gram_sum_plain(torch.from_numpy(x), torch.from_numpy(y),
                             torch.tensor(sigma), WIDTHS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the differentiable entry takes the plain version on the CPU
    got2 = tmk.gram_sum(torch.from_numpy(x), torch.from_numpy(y),
                        torch.tensor(sigma), WIDTHS)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("shape,C", [((10, 7, 7), 64), ((490,), 64),
                                     ((3, 5, 7), 16), ((77,), 40)])
def test_fusion_conv_plain_matches_pallas(shape, C):
    fg, fl, w = fusion_inputs(shape, C, sum(shape) + C)
    want = j_fusion_conv(jnp.asarray(fg), jnp.asarray(fl), jnp.asarray(w),
                         interpret=True)
    got = tfc.fusion_conv_plain(*map(torch.from_numpy, (fg, fl, w)))
    assert tuple(got.shape) == shape + (C,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got2 = tops.fused_fusion_conv(*map(torch.from_numpy, (fg, fl, w)))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


# K2's tile plan: every shape gets a tiling, the large one only where it
# gives every SM a block, and each tiling's split of K = 2C among its
# thread groups takes every depth exactly once
CONV_SHAPES = [(490, 64), (100352, 64), (8192, 576), (1001, 64), (77, 40),
               (130, 100), (33, 30), (20000, 30), (1, 1), (16896, 64)]


@pytest.mark.parametrize("T,C", CONV_SHAPES)
def test_conv_plan_tiles_every_shape(T, C):
    for n_sm in (132, 114):
        plan = tfc.conv_plan(T, C, n_sm)
        assert plan in (tfc.SMALL, tfc.LARGE)
        assert plan.blocks(T, C) * plan.tokens * plan.channels >= T * C
        assert (plan is tfc.LARGE) == (tfc.LARGE.blocks(T, C) >= n_sm)
    # the CNN's training shape gets the small tiles, the LM's the large
    if (T, C) == (490, 64):
        assert tfc.conv_plan(T, C) is tfc.SMALL
    if (T, C) == (8192, 576):
        assert tfc.conv_plan(T, C) is tfc.LARGE


@pytest.mark.parametrize("plan", [tfc.SMALL, tfc.LARGE], ids=["small",
                                                              "large"])
@pytest.mark.parametrize("C", [1, 30, 40, 64, 100, 576])
def test_conv_plan_split_covers_k_exactly_once(plan, C):
    depths = [k for g in range(plan.k_split)
              for k in plan.group_depths(C, g)]
    assert sorted(depths) == list(range(2 * C))
    assert plan.k_slice % (4 * plan.k_split) == 0


def _conv_emulated(fg, fl, w, plan):
    """K2's sums as the kernel takes them under ``plan``: each thread
    group's depths in order, then the groups' sums added in group order."""
    a = torch.cat((fg, fl), -1)
    out = None
    for g in range(plan.k_split):
        ks = plan.group_depths(fg.shape[-1], g)
        part = torch.zeros(fg.shape[:-1] + (w.shape[1],))
        for k in ks:
            part = part + a[..., k:k + 1] * w[k]
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("shape,C", [((490,), 64), ((77,), 40), ((33,), 30)])
def test_fusion_conv_split_emulation_matches_pallas(shape, C):
    fg, fl, w = fusion_inputs(shape, C, sum(shape) + 3 * C)
    want = np.asarray(j_fusion_conv(jnp.asarray(fg), jnp.asarray(fl),
                                    jnp.asarray(w), interpret=True))
    for plan in (tfc.SMALL, tfc.LARGE):
        got = _conv_emulated(*map(torch.from_numpy, (fg, fl, w)), plan)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,m,d", [(10, 10, 64), (16, 16, 8), (37, 53, 64)])
def test_mk_mmd2_matches_pallas_and_oracles(n, m, d):
    x, y = rng_pair(n, m, d, 7 + n)
    want_pallas = jops.mk_mmd2(jnp.asarray(x), jnp.asarray(y), WIDTHS,
                               impl="pallas_interpret")
    want_jnp = jref.mk_mmd2_ref(jnp.asarray(x), jnp.asarray(y), WIDTHS)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.mk_mmd2(tx, ty, WIDTHS)
    got_ref = tref.mk_mmd2_ref(tx, ty, WIDTHS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_jnp),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# gradients: the autograd.Functions' closed-form backward vs jax.grad
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [(10, 10, 64), (37, 53, 16)])
def test_mk_mmd2_grad_matches_jax(n, m, d):
    x, y = rng_pair(n, m, d, 11 + m)
    jgx, jgy = jax.grad(lambda a, b: jref.mk_mmd2_ref(a, b, WIDTHS),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    gx, gy = torch.autograd.grad(tops.mk_mmd2(tx, ty, WIDTHS), (tx, ty))
    for got, want in ((gx, jgx), (gy, jgy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n,m,d", [(10, 10, 64), (8, 8, 576), (37, 53, 64)])
def test_mk_mmd2_plain_and_grad_match_pallas_and_jax_grad(n, m, d):
    """The fused kernel's plain versions: MMD^2 against the Pallas Gram
    sums in interpret mode, dx and dy (g = 1) against ``jax.grad`` of the
    oracle, and dx through the autograd.Function on the CPU the same."""
    x, y = rng_pair(n, m, d, 3 * n + m)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = jops.mk_mmd2(jx, jy, WIDTHS, impl="pallas_interpret")
    jgx, jgy = jax.grad(lambda a, b: jref.mk_mmd2_ref(a, b, WIDTHS),
                        argnums=(0, 1))(jx, jy)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    value, sigma = tmk.mk_mmd2_plain(tx, ty, WIDTHS)
    np.testing.assert_allclose(value.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    dx, dy = tmk.mk_mmd2_grad_plain(tx, ty, sigma, torch.tensor(1.0), WIDTHS)
    rx = tx.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(tmk.MkMmd2.apply(rx, ty, WIDTHS), rx)
    for got, jwant in ((dx, jgx), (dy, jgy), (gx, jgx)):
        jwant = np.asarray(jwant)
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-4,
                                   atol=1e-6 * np.abs(jwant).max())


def test_mk_mmd2_skips_the_detached_side():
    """FedMMD's global features are detached: the backward computes dx
    only, and the gradient it gives is the full one's dx."""
    x, y = map(torch.from_numpy, rng_pair(10, 12, 16, 2))
    calls = []
    real = tmk.mk_mmd2_grad_plain

    def spy(*args):
        calls.append(args[-2:])
        return real(*args)

    tmk.mk_mmd2_grad_plain = spy
    try:
        tx = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(tmk.mk_mmd2(tx, y, WIDTHS), tx)
    finally:
        tmk.mk_mmd2_grad_plain = real
    assert calls == [(True, False)]
    _, sigma = tmk.mk_mmd2_plain(x, y, WIDTHS)
    torch.testing.assert_close(
        gx, tmk.mk_mmd2_grad_plain(x, y, sigma, torch.tensor(1.0), WIDTHS)[0])


def test_gram_sum_closed_form_grad_matches_autograd_of_plain():
    x, y = rng_pair(21, 13, 32, 5)
    sigma = torch.tensor(9.0)
    grads = []
    for fn in (tmk.gram_sum, tmk.gram_sum_plain):
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = torch.from_numpy(y).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(tx, ty, sigma, WIDTHS), (tx, ty)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("shape,C", [((2, 7, 7), 64), ((5,), 12)])
def test_fusion_conv_grad_matches_jax(shape, C):
    fg, fl, w = fusion_inputs(shape, C, 3 + C)
    cot = np.random.default_rng(1).standard_normal(shape + (C,)).astype(
        np.float32)

    def jloss(a, b, c):
        return jnp.sum(jref.fusion_conv_ref(a, b, c) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (fg, fl, w)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (fg, fl, w)]
    loss = (tops.fused_fusion_conv(*ts) * torch.from_numpy(cot)).sum()
    got = torch.autograd.grad(loss, ts)
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-6 * np.abs(jg).max())


def test_fusion_conv_grad_skips_frozen_stream():
    """With E_g frozen (FedFusion training) no gradient reaches it."""
    fg, fl, w = map(torch.from_numpy, fusion_inputs((4,), 8, 0))
    fl.requires_grad_(True)
    w.requires_grad_(True)
    out = tops.fused_fusion_conv(fg, fl, w)
    gfl, gw = torch.autograd.grad(out.sum(), (fl, w))
    assert fg.grad is None and gfl.shape == fl.shape and gw.shape == w.shape


# --------------------------------------------------------------------------
# K6 ef_gather / K7 ef_scatter: plain versions vs the Pallas kernels in
# interpret mode, exact (both only move bytes)
# --------------------------------------------------------------------------

from repro.kernels import compress_pack as jcp  # noqa: E402
from repro_torch.kernels import compress_pack as tcp  # noqa: E402


@pytest.mark.parametrize("shape,k", [((10, 300), 4), ((7, 3, 5), 3),
                                     ((40, 1001), 40), ((5, 128), 1)])
def test_ef_rows_plain_match_pallas(shape, k):
    rng = np.random.default_rng(shape[0] + k)
    table = rng.standard_normal(shape).astype(np.float32)
    rows = rng.standard_normal((k,) + shape[1:]).astype(np.float32)
    idx = rng.choice(shape[0], k, replace=False).astype(np.int32)
    want_g = np.asarray(jcp.ef_gather(jnp.asarray(table), jnp.asarray(idx),
                                      interpret=True))
    want_s = np.asarray(jcp.ef_scatter(jnp.asarray(table), jnp.asarray(idx),
                                       jnp.asarray(rows), interpret=True))
    tt = torch.from_numpy(table.copy())
    ti = torch.from_numpy(idx)
    np.testing.assert_array_equal(tcp.ef_gather_plain(tt, ti).numpy(), want_g)
    np.testing.assert_array_equal(
        tops.ef_gather(tt, ti.long()).numpy(), want_g)
    np.testing.assert_array_equal(
        tref.ef_gather_ref(tt, ti).numpy(), want_g)
    out = tcp.ef_scatter_plain(tt, ti, torch.from_numpy(rows))
    assert out is tt                                    # in place
    np.testing.assert_array_equal(tt.numpy(), want_s)
    again = torch.from_numpy(table.copy())
    tops.ef_scatter(again, ti, torch.from_numpy(rows))
    np.testing.assert_array_equal(again.numpy(), want_s)
    np.testing.assert_array_equal(tref.ef_scatter_ref(
        torch.from_numpy(table.copy()), ti, torch.from_numpy(rows)).numpy(),
        want_s)


def test_ef_scatter_plain_scratch_row_duplicates_match_pallas():
    """Duplicate ids may only target a scratch row: owned rows come out
    exact, as the JAX contract (tests/test_kernels.py) pins."""
    rng = np.random.default_rng(11)
    table = np.concatenate([rng.standard_normal((5, 40)),
                            np.zeros((1, 40))]).astype(np.float32)
    rows = rng.standard_normal((4, 40)).astype(np.float32)
    safe_idx = np.array([3, 5, 1, 5], np.int32)
    want = np.asarray(jcp.ef_scatter(jnp.asarray(table),
                                     jnp.asarray(safe_idx),
                                     jnp.asarray(rows), interpret=True))
    got = tcp.ef_scatter_plain(torch.from_numpy(table.copy()),
                               torch.from_numpy(safe_idx),
                               torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got[:5], want[:5])
    np.testing.assert_array_equal(got[[3, 1]], rows[[0, 2]])
