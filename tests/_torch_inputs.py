"""Seeded numpy inputs and reduced configs shared by the port's tests (no
JAX here: ``test_torch_cuda.py`` runs on the GPU host, which has none)."""
import dataclasses

import numpy as np

WIDTHS = (1.0, 2.0, 4.0, 8.0, 16.0)
# ``ArchConfig.reduced()`` sets head_dim = d_model // n_heads = 64; these
# configs keep the head dim the attention kernels are built for
OWN_HEAD_DIMS = {"stablelm-3b": 80, "h2o-danube-3-4b": 120}


def reduced(cfg, **changes):
    """``cfg.reduced()`` (a JAX or a port config) at the config's own head
    dim where that is not 64, with ``changes`` applied."""
    if cfg.name in OWN_HEAD_DIMS:
        changes.setdefault("head_dim", OWN_HEAD_DIMS[cfg.name])
    return dataclasses.replace(cfg.reduced(), **changes)


def rng_pair(n, m, d, seed):
    """x [n, d] ~ N(0, 1) and y [m, d] ~ N(1, 0.25), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (0.5 * rng.standard_normal((m, d)) + 1.0).astype(np.float32)
    return x, y


def fusion_inputs(shape, C, seed):
    """f_g, f_l [*shape, C] ~ N(0, 1) and w [2C, C] ~ N(0, 1/2C), float32."""
    rng = np.random.default_rng(seed)
    fg = rng.standard_normal(shape + (C,)).astype(np.float32)
    fl = rng.standard_normal(shape + (C,)).astype(np.float32)
    w = (rng.standard_normal((2 * C, C)) / np.sqrt(2 * C)).astype(np.float32)
    return fg, fl, w


# K5's edge cases: the threshold a tie (an entry's |x|), 0, negative, +inf
TOPK_EDGE_T = ("tie", "zero", "negative", "inf")


def topk_edge_case(n, case):
    """x float32 [n] ~ N(0, 1) holding NaN, +-inf, -0.0, +0.0 and +-t (as
    many as n allows, a different set for each case when n < 7), and the
    threshold t of ``case`` (one of ``TOPK_EDGE_T``), as float32."""
    rng = np.random.default_rng(7 * n + len(case))
    x = rng.standard_normal(n).astype(np.float32)
    t = {"tie": np.sort(np.abs(x))[-(n + 1) // 2], "zero": np.float32(0),
         "negative": np.float32(-0.5), "inf": np.float32(np.inf)}[case]
    special = np.array([np.nan, np.inf, -np.inf, -0.0, t, -t, 0.0],
                       np.float32)
    m = min(n, special.size)
    at = rng.choice(n, size=m, replace=False)
    x[at] = np.roll(special, -TOPK_EDGE_T.index(case))[:m]
    return x, np.float32(t)


# --------------------------------------------------------------------------
# the recurrent layers' model split, rank by rank in one process
# --------------------------------------------------------------------------

def rglru_by_ranks(params, x, m):
    """``models.rglru``'s split over ``m`` model ranks, run rank by rank:
    each rank's first stage on its blocks (``w_x`` / ``w_gate`` / ``w_a`` /
    ``w_i`` columns, ``w_out`` rows, its W slice of the replicated leaves),
    the conv outputs joined (the all-gather), each rank's second stage,
    the parts summed (the all-reduce).  Returns (y [B,S,d], each rank's
    cache blocks ``{"h", "conv"}``)."""
    from repro_torch.models import rglru
    W = params["w_x"].shape[1]
    n = W // m
    ranks = []
    for r in range(m):
        sl = slice(r * n, (r + 1) * n)
        p = dict(params, w_x=params["w_x"][:, sl],
                 w_gate=params["w_gate"][:, sl], w_a=params["w_a"][:, sl],
                 w_i=params["w_i"][:, sl], w_out=params["w_out"][sl])
        rep = {k: params[k][..., sl] for k in rglru._REPLICATED}
        u_in, u = rglru.rglru_block_in(p, x, rep)
        ranks.append((p, rep, u_in, u))
    u_all = _cat([u for *_, u in ranks], -1)
    y, caches = 0, []
    for p, rep, u_in, u in ranks:
        part, hseq = rglru.rglru_block_out(p, x, rep, u, u_all)
        y = y + part
        caches.append({"h": hseq[:, -1], "conv": u_in[:, -3:]})
    return y, caches


def ssd_by_ranks(params, x, m, *, expand, d_state, head_dim, chunk,
                 conv_width):
    """``models.ssd``'s split over ``m`` model ranks, run rank by rank: the
    projection and the conv whole, each rank's scan on its P slice of
    every head (:func:`repro_torch.models.ssd.ssd_block`), the slices
    joined on P (the all-gather), each rank's row block of ``y *
    silu(z)`` against its rows of ``w_out``, the parts summed.  Returns
    y [B,S,d]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssd
    Bsz, S, d = x.shape
    d_inner = expand * d
    H = d_inner // head_dim
    z, xBC_in, dt = ssd._split_proj(params, x, (d_inner, d_state, H))
    xBC = F.silu(ssd._causal_conv(xBC_in, params["conv_w"],
                                  params["conv_b"]))
    xs = xBC[..., :d_inner].reshape(Bsz, S, H, head_dim)
    Bm = xBC[..., d_inner:d_inner + d_state]
    Cm = xBC[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    P = head_dim // m
    y = _cat([ssd.ssd_block(xs[..., r * P:(r + 1) * P], Bm, Cm, dt, A,
                            params["D"], chunk) for r in range(m)], -1)
    y = y.reshape(Bsz, S, d_inner) * F.silu(z)
    rows = d_inner // m
    return sum(y[..., r * rows:(r + 1) * rows]
               @ params["w_out"][r * rows:(r + 1) * rows] for r in range(m))


def _cat(parts, dim):
    import torch
    return torch.cat(parts, dim=dim)
