"""GQA attention (port of ``repro/models/attention.py``).

Shapes, as in the JAX package: q [B, S, H, hd], k/v [B, S, KV, hd] with
H = KV * rep; query head ``g * rep + r`` attends with KV head ``g``.

``flash_attention`` is the ``attn_impl="jnp"`` sequence path.  The JAX
package runs a blocked online softmax there that XLA compiles, outside
any Pallas kernel; the port computes the same function as a plain masked
softmax in float32 (the S x S scores are materialised: fine at serving
lengths, and the ``attn_impl="pallas"`` path runs K8a instead), through
the masked softmax that is also K8a's and K9's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import masked_softmax_attention
from repro_torch.models.layers import dense_init
from repro_torch.parallel import (copy_to_model, gather_from_model,
                                  model_dim, reduce_from_model)


def attn_init(generator, d_model, n_heads, n_kv_heads, head_dim,
              dtype=torch.float32):
    return {
        "wq": dense_init(generator, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(generator, (n_heads * head_dim, d_model), dtype),
    }


def head_parallel(n_heads, n_kv_heads, mp) -> bool:
    """Whether a layer split over ``model`` runs its heads in parallel:
    each rank's column block of ``wq`` / ``wk`` / ``wv`` (and row block of
    ``wo``) is whole heads.  Otherwise the JAX layouts may cut inside a
    head (smollm-135m's ``wk`` [576, 192] at m = 16 gives 12 columns a
    rank; gemma3-1b's one KV head is cut at m = 2), where GSPMD reshards:
    the port gathers the projection's blocks instead (:func:`project_qkv`)."""
    m = 1 if mp is None else mp.size
    return m > 1 and n_heads % m == 0 and n_kv_heads % m == 0


def _split(spec, mp):
    return (mp is not None and mp.active and spec is not None
            and model_dim(spec) is not None)


def project_qkv(params, x, n_heads, n_kv_heads, head_dim, *, mp=None,
                specs=None, gather=False, names=("wq", "wk", "wv")):
    """q [B,S,H,hd], k / v [B,S,KV,hd] from x [B,S,d] (``names`` picks
    which of the three, in that order: a cross-attention projects q from
    the decoder and k / v from the encoder).

    Tensor-parallel (``mp`` of more than one rank, ``specs`` the leaves'
    specs): head-parallel layers (:func:`head_parallel`) return this
    rank's heads, H / m and KV / m of them, unless ``gather``; other
    layers, and ``gather=True``, return all heads on every rank, each
    split projection's column blocks joined by
    ``parallel.gather_from_model``.  A projection whose leaf is replicated runs
    whole; its output is copied to ``model`` (its gradient then arrives in
    rank-dependent parts, from this rank's block of the heads, and is
    summed there)."""
    B, S, _ = x.shape
    heads = {"wq": n_heads, "wk": n_kv_heads, "wv": n_kv_heads}
    if mp is None or not mp.active or specs is None:
        return tuple((x @ params[name]).reshape(B, S, heads[name], head_dim)
                     for name in names)
    xin = copy_to_model(x, mp)
    local = head_parallel(n_heads, n_kv_heads, mp) and not gather
    out = []
    for name in names:
        if _split(specs[name], mp):
            y = xin @ params[name]
            if not local:
                y = gather_from_model(y, -1, mp)
        else:
            y = copy_to_model(x @ params[name], mp)
        out.append(y.reshape(B, S, -1, head_dim))
    return tuple(out)


def project_out(params, o, *, mp=None, specs=None):
    """o [B,S,H',hd] @ wo.  Tensor-parallel with ``wo`` split on its rows:
    o holds this rank's heads (H' = H / m, head-parallel) or all heads, of
    which this rank feeds its block of columns to its rows; the products
    are reduced over ``model``."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if not _split(specs["wo"] if specs is not None else None, mp):
        return o @ params["wo"]
    rows = params["wo"].shape[0]
    if o.shape[-1] != rows:
        o = o[..., mp.rank * rows:(mp.rank + 1) * rows]
    return reduce_from_model(o @ params["wo"], mp)


def flash_attention(q, k, v, *, window=None, q_offset=0, causal=True):
    """Causal (default), sliding-window or bidirectional attention.

    q [B,Sq,H,hd], k/v [B,Sk,KV,hd] (Sq and Sk may differ); returns
    [B,Sq,H,hd] in q's dtype.  ``q_offset``: global position of q[0].
    """
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones(len(q_pos), len(k_pos), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return masked_softmax_attention(q, k, v, mask)[0]


def decode_attention(q, k_cache, v_cache, *, cache_len=None, window=None,
                     kernel=None):
    """q [B,1,H,hd]; caches [B,L,KV,hd]. Returns [B,1,H,hd].

    ``cache_len``: number of valid cache positions (an int, an int tensor
    or None = all).  ``window``: for sliding-window layers whose cache is
    already the ring buffer, pass None (the cache itself is the window).
    ``kernel``: an accelerated implementation (flash-decode, K9);
    signature (q, k, v, valid_len) -> out.
    """
    if kernel is not None:
        return kernel(q, k_cache, v_cache, cache_len)
    L = k_cache.shape[1]
    pos = torch.arange(L, device=q.device)
    valid = torch.ones(L, dtype=torch.bool, device=q.device) \
        if cache_len is None else pos < cache_len
    if window is not None:
        hi = L if cache_len is None else cache_len
        valid = valid & (pos >= hi - window)
    return masked_softmax_attention(q, k_cache, v_cache, valid[None, :])[0]


def reference_attention(q, k, v, *, window=None, q_offset=0, causal=True):
    """Naive O(S^2) oracle for tests."""
    return flash_attention(q, k, v, window=window, q_offset=q_offset,
                           causal=causal)
