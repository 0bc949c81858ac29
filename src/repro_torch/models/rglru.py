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

Split over ``model`` (``mp`` of more than one rank, ``specs`` the leaves'
specs with ``w_x`` split on W): the JAX layout's blocks, ``w_x``,
``w_gate``, ``w_a``, ``w_i`` column-parallel on W and ``w_out``
row-parallel, ``conv_w``, ``conv_b``, ``lam``, ``b_a``, ``b_i``
replicated, the cache ``h`` and ``conv`` split on W.  Each rank computes
its W block of the conv output ``u``; the gates multiply the WHOLE ``u``
by their column blocks, so ``u`` is gathered over ``model`` before them
(:func:`repro_torch.parallel.gather_from_model`: the gates' gradients
are partial); the recurrence, the gate branch and the cache are the
rank's W block; ``w_out``'s products are reduced.  The replicated leaves
are used through the rank's W slice after a ``copy_to_model``, so their
gradients sum the ranks' slices and the copies stay equal.  The stages
(:func:`rglru_block_in`, :func:`rglru_block_out`) take a rank's blocks:
a test runs them rank by rank in one process.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.ssd import _causal_conv
from repro_torch.parallel import (copy_to_model, gather_from_model,
                                  model_dim, reduce_from_model)

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


_REPLICATED = ("conv_w", "conv_b", "lam", "b_a", "b_i")


def _gates(params, rep, u, u_all):
    """The rank's (log_a, gated input) [..., W_loc] in f32: the gates are
    the whole conv output ``u_all`` times the column blocks of ``w_a`` /
    ``w_i``, the input the rank's block ``u`` (one device: both whole)."""
    x32 = u_all.float()
    r = torch.sigmoid(x32 @ params["w_a"].float() + rep["b_a"].float())
    i = torch.sigmoid(x32 @ params["w_i"].float() + rep["b_i"].float())
    log_a = -_C * F.softplus(rep["lam"].float()) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * (i * u.float())


def _split(mp, specs) -> bool:
    return (mp is not None and mp.active and specs is not None
            and model_dim(specs["w_x"]) == 1)


def _rank_parts(params, x, mp, split):
    """(x as the column blocks' input, the replicated leaves as this rank
    uses them: its W slice after a ``copy_to_model``)."""
    if not split:
        return x, {k: params[k] for k in _REPLICATED}
    W_loc = params["w_x"].shape[1]
    sl = slice(mp.rank * W_loc, (mp.rank + 1) * W_loc)
    return copy_to_model(x, mp), {k: copy_to_model(params[k], mp)[..., sl]
                                  for k in _REPLICATED}


def rglru_block_in(params, x, rep):
    """A rank's first stage: (the conv's input ``x @ w_x`` and output
    ``u``), its W block [B,S,W_loc] (``rep``: its slices of the replicated
    leaves)."""
    u_in = x @ params["w_x"]
    return u_in, _causal_conv(u_in, rep["conv_w"], rep["conv_b"])


def rglru_block_out(params, x, rep, u, u_all):
    """A rank's second stage from its ``u`` block and the gathered
    ``u_all``: (its part of the output [B,S,d], a partial sum over the
    ranks; its W block of the states [B,S,W_loc] f32)."""
    log_a, b = _gates(params, rep, u, u_all)
    hseq = linear_scan(torch.exp(log_a), b)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    return (hseq.to(x.dtype) * gate) @ params["w_out"], hseq


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


def rglru_apply(params, x, conv_width=4, want_cache=False, *, mp=None,
                specs=None):
    """Sequence mode. x [B,S,d] -> [B,S,d]; with ``want_cache`` (y, the
    decode cache after the sequence: the last state and the last
    ``conv_width - 1`` conv inputs, as ``transformer._rglru_seq_cache``
    makes them in the JAX package; the rank's W block of each under
    ``mp``, module docstring)."""
    split = _split(mp, specs)
    xin, rep = _rank_parts(params, x, mp, split)
    u_in, u = rglru_block_in(params, xin, rep)
    u_all = gather_from_model(u, -1, mp) if split else u
    y, hseq = rglru_block_out(params, xin, rep, u, u_all)
    if split:
        y = reduce_from_model(y, mp)
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


def rglru_decode(params, x, cache, conv_width=4, *, mp=None, specs=None):
    """x [B,1,d] -> (y [B,1,d], new cache): fresh tensors, the cache read
    only (under ``mp`` the cache and the new one are the rank's W
    blocks)."""
    split = _split(mp, specs)
    xin, rep = _rank_parts(params, x, mp, split)
    u = xin @ params["w_x"]                                    # [B,1,W]
    win = torch.cat([cache["conv"], u], dim=1)
    u1 = (win * rep["conv_w"]).sum(1) + rep["conv_b"]
    log_a, b = _gates(params, rep, u1,
                      gather_from_model(u1, -1, mp) if split else u1)
    h = torch.exp(log_a) * cache["h"] + b
    gate = F.gelu(xin[:, 0] @ params["w_gate"], approximate="tanh")
    y = (h.to(x.dtype) * gate) @ params["w_out"]
    if split:
        y = reduce_from_model(y, mp)
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
