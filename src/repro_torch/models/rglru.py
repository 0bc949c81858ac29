"""RecurrentGemma RG-LRU recurrent block (Griffin, arXiv:2402.19427; port
of ``repro/models/rglru.py``).

Block = gated dual branch:
    branch A: linear -> causal conv1d(w=4) -> RG-LRU
    branch B: linear -> GeLU (the tanh form, ``jax.nn.gelu``'s default)
    out     = linear(branch A * branch B)

RG-LRU recurrence (elementwise, width W), gates in float32:
    r_t = sigmoid(x_t @ W_a + b_a)            recurrence gate
    i_t = sigmoid(x_t @ W_x + b_x)            input gate
    log_a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2*log_a_t)) * (i_t * x_t)

Sequence mode solves the linear recurrence h_t = a_t h_{t-1} + b_t with a
log-depth doubling scan (Hillis-Steele, :func:`linear_scan`): ceil(log2
S) steps of whole-sequence elementwise ops (10 at S = 1,024), where the
JAX package runs ``lax.associative_scan``.  The two add the same terms in
another order, so they agree within float32 rounding, not bit for bit.
Chosen over a Python loop over positions (S steps of a few launches each)
and over a chunked closed form (exp of cumulative log-decays overflows
float32 within a few positions at c = 8).  Its cost in training: autograd
keeps the previous (a, b) pair of every step, 2 ceil(log2 S) tensors of
[B, S, W] float32 a layer (0.67 GB at B 2, S 1,024, W 4,096), freed by
the backward; ``remat="layer"`` recomputes them instead.

The depthwise causal conv is the same sum of W shifted products as
:mod:`repro_torch.models.ssd`'s.  Decode carries ``{"h": [B, W] f32,
"conv": [B, W_conv - 1, W]}`` and returns a new cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.ssd import _causal_conv

_C = 8.0


def rglru_init(generator, d_model, lru_width, conv_width=4,
               dtype=torch.float32):
    dev = generator.device
    return {
        "w_x": dense_init(generator, (d_model, lru_width), dtype),
        "w_gate": dense_init(generator, (d_model, lru_width), dtype),
        "conv_w": dense_init(generator, (conv_width, lru_width), dtype,
                             scale=0.5),
        "conv_b": torch.zeros((lru_width,), dtype=dtype, device=dev),
        "lam": torch.linspace(-2.0, 2.0, lru_width,
                              device=dev).to(dtype),   # softplus arg
        "w_a": dense_init(generator, (lru_width, lru_width), dtype),
        "b_a": torch.zeros((lru_width,), dtype=dtype, device=dev),
        "w_i": dense_init(generator, (lru_width, lru_width), dtype),
        "b_i": torch.zeros((lru_width,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, (lru_width, d_model), dtype),
    }


def _gates(params, x):
    """x [..., W] -> (log_a [..., W], gated input [..., W]) in f32."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(x32 @ params["w_i"].float() + params["b_i"].float())
    log_a = -_C * F.softplus(params["lam"].float()) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * (i * x32)


def linear_scan(a, b):
    """h [B,S,W] with h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0):
    after the step of span k, (a_t, b_t) composes the k positions up to
    t, so b_t = h_t once k reaches S."""
    S, k = a.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_apply(params, x, conv_width=4, want_cache=False):
    """Sequence mode. x [B,S,d] -> [B,S,d]; with ``want_cache`` (y, the
    decode cache after the sequence: the last state and the last
    ``conv_width - 1`` conv inputs, as ``transformer._rglru_seq_cache``
    makes them in the JAX package)."""
    u_in = x @ params["w_x"]
    u = _causal_conv(u_in, params["conv_w"], params["conv_b"])
    log_a, b = _gates(params, u)
    hseq = linear_scan(torch.exp(log_a), b)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    y = (hseq.to(x.dtype) * gate) @ params["w_out"]
    if not want_cache:
        return y
    S, W1 = x.shape[1], conv_width - 1
    if S < W1:
        raise ValueError(f"an RG-LRU prefill of {S} tokens is shorter than "
                         f"the conv window's {W1} (conv_width - 1) cached "
                         "inputs")
    return y, {"h": hseq[:, -1], "conv": u_in[:, S - W1:].contiguous()}


def rglru_init_cache(batch, lru_width, conv_width=4, dtype=torch.float32,
                     device=None):
    return {
        "h": torch.zeros((batch, lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, conv_width - 1, lru_width), dtype=dtype,
                            device=device),
    }


def rglru_decode(params, x, cache, conv_width=4):
    """x [B,1,d] -> (y [B,1,d], new cache): fresh tensors, the cache read
    only."""
    u = x @ params["w_x"]                                      # [B,1,W]
    win = torch.cat([cache["conv"], u], dim=1)
    u1 = (win * params["conv_w"]).sum(1) + params["conv_b"]
    log_a, b = _gates(params, u1)
    h = torch.exp(log_a) * cache["h"] + b
    gate = F.gelu(x[:, 0] @ params["w_gate"], approximate="tanh")
    y = (h.to(x.dtype) * gate) @ params["w_out"]
    return y[:, None, :], {"h": h, "conv": win[:, 1:]}


def rglru_reference(params, x, conv_width=4):
    """Step-wise oracle for tests."""
    B, S, _ = x.shape
    cache = rglru_init_cache(B, params["w_x"].shape[1], conv_width, x.dtype,
                             x.device)
    ys = []
    for t in range(S):
        y, cache = rglru_decode(params, x[:, t:t + 1], cache, conv_width)
        ys.append(y)
    return torch.cat(ys, dim=1)
