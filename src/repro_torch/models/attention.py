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


def attn_init(generator, d_model, n_heads, n_kv_heads, head_dim,
              dtype=torch.float32):
    return {
        "wq": dense_init(generator, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(generator, (n_heads * head_dim, d_model), dtype),
    }


def project_qkv(params, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def project_out(params, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"]


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
