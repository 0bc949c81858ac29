"""The CUDA kernels (K1 Gram sum, K2 fusion conv) against their plain
PyTorch versions on the card, and the wrappers' refusals.

Imports torch and the port only (no JAX), so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tests marked ``cuda`` skip where torch finds no CUDA device.  Tolerances:
the Gram sum is a float32 sum of n*m positive terms taken in another order
than the plain version's, so the two agree to rtol 1e-5; the fusion conv
sums K = 2C products per output, held to 1e-5 of the output's scale; the
gradient is a difference of two sums that cancel in part, held to rtol
1e-4 with an atol of 1e-6 of its scale.
"""
import pytest
import torch
from _torch_inputs import WIDTHS, fusion_inputs, rng_pair

from repro_torch.kernels import fusion_conv as tfc
from repro_torch.kernels import mk_mmd as tmk
from repro_torch.kernels import ops as tops


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
@pytest.mark.parametrize("T,C", [(490, 64), (100352, 64), (1001, 64),
                                 (77, 40), (130, 100)])
def test_fusion_conv_kernel_matches_plain(cuda_device, T, C):
    torch.backends.cuda.matmul.allow_tf32 = False
    fg, fl, w = (torch.from_numpy(a).to(cuda_device)
                 for a in fusion_inputs((T,), C, T + C))
    before = tfc.fusion_conv_cuda.launches
    got = tfc.fusion_conv_cuda(fg, fl, w)
    want = tfc.fusion_conv_plain(fg, fl, w)
    torch.cuda.synchronize()
    assert tfc.fusion_conv_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


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
