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
