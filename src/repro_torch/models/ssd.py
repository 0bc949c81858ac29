"""Mamba-2 SSD (state-space duality) block (port of ``repro/models/ssd.py``).

The SSD recurrence per head (state N, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (x_t outer B_t)        [P, N]
    y_t = h_t @ C_t + D * x_t
is computed chunk-wise (arXiv:2405.21060 §6): attention-like products
within a chunk of Q positions, and the carried state across chunks.  All
decays are exponentials of non-positive log-decays, so every exp() is at
most 1.  The weights are the JAX package's leaves: ``w_in`` [d, d_inner +
conv_ch + H] (the gate z, the conv input [x, B, C] and dt), ``conv_w``
[W, conv_ch], ``conv_b``, ``A_log`` / ``dt_bias`` / ``D`` [H], ``w_out``
[d_inner, d].

Where the torch code differs from the JAX code, not in what it computes:

* The chunked scan (:func:`_ssd_chunked`) computes the within-chunk
  products of every chunk at once (static shapes, [B, S / Q, Q, ...]); only
  the carried state runs in a Python loop over the S / Q chunks, a few
  small ops each, where JAX runs the whole chunk body under ``lax.scan``.
  The mask of the upper triangle goes on the log-decay before the exp,
  as in JAX (``masked_fill`` to -1e30): masked after the exp, the upper
  triangle's exp(+large) = inf would make NaN gradients.
* The depthwise causal conv is a sum of W shifted products (elementwise
  ops; JAX's ``conv_general_dilated`` cross-correlation, the weight not
  flipped), so its backward adds in a fixed order on every device.
* ``F.softplus`` returns x itself above x = 20, where ``jax.nn.softplus``
  is ``logaddexp(x, 0)`` everywhere: they differ by log1p(exp(-x)) <
  2.1e-9 there, far below the parity tests' bounds.

Decode (:func:`ssd_decode`) carries ``{"h": [B, H, P, N] f32, "conv": [B,
W - 1, conv_ch]}`` (the last W - 1 conv inputs, before the conv) and
returns a new cache; ``models.transformer`` copies it into its cache in
place.

Split over ``model`` (``mp`` of more than one rank, ``specs`` the leaves'
specs): the JAX layout replicates ``w_in`` and the small leaves, splits
``w_out`` on its rows (d_inner, head-major), and splits the cache's state
[B, H, P, N] on P and its conv window [B, W - 1, conv_ch] on conv_ch,
which mixes the x, B and C channels.  The recurrence is independent over
P, so each rank computes the P slice of every head: the projection and
the conv run whole on every rank (their outputs enter the rank's part
through ``copy_to_model``, so every replicated leaf's gradient sums the
ranks' parts), the chunked scan and ``D x`` run on the rank's P slice,
``y`` is gathered over ``model`` (P), the rank's row block of ``y *
silu(z)`` meets its rows of ``w_out``, and the products are reduced.  A
decode step gathers the small conv window, computes the rank's P slice of
the new state and writes back only its conv_ch block.  The P and conv_ch
splits follow the cache rule (``launch.sharding.cache_shardings``: a dim
is split where ``model`` divides it).  :func:`ssd_block` is a rank's
part of the scan: a test runs it rank by rank in one process.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel import (copy_to_model, gather_from_model,
                                  model_dim, reduce_from_model)


def ssd_init(generator, d_model, *, expand, d_state, head_dim, conv_width,
             dtype=torch.float32):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state   # the conv runs over [x, B, C] jointly
    dev = generator.device
    return {
        # in_proj -> [z (gate), xBC, dt]
        "w_in": dense_init(generator,
                           (d_model, d_inner + conv_ch + n_heads), dtype),
        "conv_w": dense_init(generator, (conv_width, conv_ch), dtype,
                             scale=0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=dev)).to(dtype),
        "dt_bias": torch.zeros((n_heads,), dtype=dtype, device=dev),
        "D": torch.ones((n_heads,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, (d_inner, d_model), dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x [B,S,C], w [W,C] -> [B,S,C]:
    out[t] = sum_k w[k] * x[t - (W - 1) + k] + b (x zero before 0)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * w[k]
    return out + b


def _split_proj(params, x, cfg_dims):
    d_inner, d_state, n_heads = cfg_dims
    proj = x @ params["w_in"]
    conv_ch = d_inner + 2 * d_state
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + conv_ch]
    dt = proj[..., d_inner + conv_ch:]
    return z, xBC, dt


def _splits(mp, specs, head_dim, conv_ch):
    """(w_out split on its rows, the P split, the conv_ch split) over
    ``model``, the last two by the cache rule."""
    m = mp.size if mp is not None and mp.active and specs is not None else 1
    rows = m > 1 and model_dim(specs["w_out"]) == 0
    return rows, rows and head_dim % m == 0, m > 1 and conv_ch % m == 0


def _rank_slice(mp, n_loc):
    return slice(mp.rank * n_loc, (mp.rank + 1) * n_loc)


def ssd_block(xs, Bmat, Cmat, dt, A, D, chunk):
    """The scan's output y [B,S,H,P'] (P' = P or a rank's P slice) of
    ``xs`` [B,S,H,P'] with the shared B / C [B,S,N], dt [B,S,H] (after
    softplus), A [H] and the skip ``D`` [H]."""
    y = _ssd_chunked(xs, Bmat, Cmat, dt, A, chunk)
    return y + D.to(y.dtype)[None, None, :, None] * xs


def _out(params, y, z, mp, rows):
    """``(y * silu(z)) @ w_out`` of y [..., d_inner] whole; under ``rows``
    the rank's row block meets its rows of ``w_out``, reduced."""
    y = y * F.silu(z)
    if not rows:
        return y @ params["w_out"]
    n = params["w_out"].shape[0]
    return reduce_from_model(y[..., _rank_slice(mp, n)] @ params["w_out"],
                             mp)


def ssd_apply(params, x, *, expand, d_state, head_dim, chunk, conv_width,
              want_cache=False, mp=None, specs=None):
    """Sequence mode. x [B,S,d] -> y [B,S,d]; with ``want_cache`` (y,
    the decode cache after the sequence): the last W - 1 conv inputs and
    the final state in the JAX package's closed form
    (``transformer._ssd_seq_with_cache``): h = sum_t exp(sum_{j>t} a_j)
    dt_t x_t outer B_t.  Under ``mp`` the cache is the rank's blocks
    (module docstring)."""
    Bsz, S, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    rows, p_split, c_split = _splits(mp, specs, head_dim, conv_ch)
    z, xBC_in, dt = _split_proj(params, x, (d_inner, d_state, n_heads))
    xBC = F.silu(_causal_conv(xBC_in, params["conv_w"], params["conv_b"]))
    dt = F.softplus(dt.float() + params["dt_bias"].float())    # [B,S,H]
    A = -torch.exp(params["A_log"].float())                    # [H] < 0
    D = params["D"]
    if rows:     # the rank's part consumes them: sum their gradients
        xBC, z, dt, A, D = (copy_to_model(t, mp) for t in (xBC, z, dt, A, D))
    xs = xBC[..., :d_inner].reshape(Bsz, S, n_heads, head_dim)
    Bmat = xBC[..., d_inner:d_inner + d_state]                 # [B,S,N]
    Cmat = xBC[..., d_inner + d_state:]                        # [B,S,N]
    if p_split:
        xs = xs[..., _rank_slice(mp, head_dim // mp.size)]
    y = ssd_block(xs, Bmat, Cmat, dt, A, D, chunk)
    if p_split:
        y = gather_from_model(y, -1, mp)
    y = _out(params, y.reshape(Bsz, S, d_inner), z, mp, rows)
    if not want_cache:
        return y
    W1 = conv_width - 1
    if S < W1:
        raise ValueError(f"an SSD prefill of {S} tokens is shorter than "
                         f"the conv window's {W1} (conv_width - 1) cached "
                         "inputs")
    a = dt * A[None, None, :]
    rev_cum = torch.flip(torch.cumsum(torch.flip(a, [1]), 1), [1]) - a
    w = torch.exp(rev_cum) * dt                              # [B,S,H]
    h = torch.einsum("bshp,bsn->bhpn", w[..., None] * xs.float(),
                     Bmat.float())
    conv = xBC_in[:, S - W1:]
    if c_split:
        conv = conv[..., _rank_slice(mp, conv_ch // mp.size)]
    return y, {"h": h, "conv": conv.contiguous()}


def _ssd_chunked(xs, Bmat, Cmat, dt, A, chunk):
    """Core chunked SSD. xs [B,S,H,P]; B/C [B,S,N]; dt [B,S,H]; A [H].
    The chunk length Q is ``min(chunk, S)`` halved until it divides S
    (a prompt of odd length runs with Q = 1)."""
    Bsz, S, H, P = xs.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q
    xc = xs.float().reshape(Bsz, nc, Q, H, P)
    Bc = Bmat.float().reshape(Bsz, nc, Q, N)
    Cc = Cmat.float().reshape(Bsz, nc, Q, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)               # [B,nc,Q,H], <= 0
    # intra-chunk: the attention-like lower-triangular mix.  Masked in LOG
    # space before the exp: -1e30 exps to exactly 0 with zero gradient
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,Q,K,H]
    upper = ~torch.ones((Q, Q), dtype=torch.bool,
                        device=xs.device).tril()
    decay = torch.exp(diff.masked_fill(upper[:, :, None], -1e30))
    dtx = dtc[..., None] * xc                                 # [B,nc,K,H,P]
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * decay, dtx)
    # each chunk's own state contribution, and the carried state
    w_k = torch.exp(cum[:, :, -1:] - cum) * dtc              # [B,nc,K,H]
    S_c = torch.einsum("bckhp,bckn->bchpn", w_k[..., None] * xc, Bc)
    last = torch.exp(cum[:, :, -1])[..., None, None]         # [B,nc,H,1,1]
    h = xs.new_zeros((Bsz, H, P, N), dtype=torch.float32)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = last[:, c] * h + S_c[:, c]
    h_prev = torch.stack(prev, 1)                            # [B,nc,H,P,N]
    # inter-chunk: the carried state's contribution
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * torch.exp(cum)[..., None]
    return y.to(xs.dtype).reshape(Bsz, S, H, P)


# ---------------------------------------------------------------------------
# Decode (single token, carried state)
# ---------------------------------------------------------------------------

def ssd_init_cache(batch, d_model, *, expand, d_state, head_dim, conv_width,
                   dtype=torch.float32, device=None):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    return {
        "h": torch.zeros((batch, n_heads, head_dim, d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssd_decode(params, x, cache, *, expand, d_state, head_dim, conv_width,
               mp=None, specs=None):
    """x [B,1,d] -> (y [B,1,d], new cache): fresh tensors, the cache
    read only (under ``mp`` the rank's blocks, module docstring)."""
    Bsz, _, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    rows, p_split, c_split = _splits(mp, specs, head_dim, conv_ch)
    z, xBC, dt = _split_proj(params, x, (d_inner, d_state, n_heads))
    # conv over the stored window + the current input
    stored = gather_from_model(cache["conv"], -1, mp) if c_split \
        else cache["conv"]
    win = torch.cat([stored, xBC], dim=1)                    # [B,W,ch]
    conv_out = (win * params["conv_w"]).sum(1) + params["conv_b"]
    xBC = F.silu(conv_out)[:, None, :]
    new_conv = win[:, 1:]
    if c_split:
        new_conv = new_conv[..., _rank_slice(mp, conv_ch // mp.size)]

    xs = xBC[..., :d_inner].reshape(Bsz, n_heads, head_dim)
    if p_split:
        xs = xs[..., _rank_slice(mp, head_dim // mp.size)]
    Bv = xBC[:, 0, d_inner:d_inner + d_state]                # [B,N]
    Cv = xBC[:, 0, d_inner + d_state:]
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # [B,H]
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dtv * A[None, :])                      # [B,H]
    upd = (dtv[..., None] * xs.float())[..., None] * Bv.float()[:, None,
                                                                 None, :]
    h = decay[:, :, None, None] * cache["h"] + upd
    y = torch.einsum("bhpn,bn->bhp", h, Cv.float())
    y = y + params["D"].float()[None, :, None] * xs
    if p_split:
        y = gather_from_model(y, -1, mp)
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    return _out(params, y, z, mp, rows), {"h": h, "conv": new_conv}


def ssd_reference(params, x, *, expand, d_state, head_dim, conv_width):
    """Step-by-step scan oracle (no chunking) for tests."""
    Bsz, S, d_model = x.shape
    cache = ssd_init_cache(Bsz, d_model, expand=expand, d_state=d_state,
                           head_dim=head_dim, conv_width=conv_width,
                           dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        y, cache = ssd_decode(params, x[:, t:t + 1], cache, expand=expand,
                              d_state=d_state, head_dim=head_dim,
                              conv_width=conv_width)
        ys.append(y)
    return torch.cat(ys, dim=1)
