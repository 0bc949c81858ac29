"""Layer primitives of the port (port of ``repro/models/layers.py``):
the fan-in init, RMS / layer norms, the MLP (SwiGLU or plain GELU), the
embedding table and Whisper's sinusoidal positions.  Weights are ``[in,
out]`` and applied as ``x @ w``, as in the JAX package."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import copy_to_model, model_dim, reduce_from_model


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale=None):
    """Truncated-normal (±2σ) fan-in init (LeCun-style), drawn from
    ``generator`` on the generator's device.  Same distribution as the JAX
    init; the numbers differ, since torch and ``jax.random`` are different
    generators."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def rmsnorm_init(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def norm_init(kind, dim, dtype=torch.float32, device=None):
    if kind == "layernorm":
        return layernorm_init(dim, dtype, device)
    return rmsnorm_init(dim, dtype, device)


def norm_apply(kind, params, x, eps=1e-6):
    if kind == "layernorm":
        return layernorm(params, x, eps)
    return rmsnorm(params, x, eps)


def mlp_init(generator, d_model, d_ff, act, dtype=torch.float32):
    """SwiGLU (``act="silu"``: w1, w2, w3) or plain GELU MLP (w1, w2)."""
    p = {"w1": dense_init(generator, (d_model, d_ff), dtype),
         "w2": dense_init(generator, (d_ff, d_model), dtype)}
    if act == "silu":
        p["w3"] = dense_init(generator, (d_model, d_ff), dtype)
    return p


def mlp_apply(params, x, act, *, mp=None, specs=None):
    """The MLP on ``x``.  Tensor-parallel (``mp`` a
    :class:`repro_torch.parallel.ModelParallel` of more than one rank,
    ``specs`` the leaves' specs): each leaf's spec says its rule.  ``w1`` /
    ``w3`` split on their output dim are column-parallel (their input
    copied to ``model``), ``w2`` split on its input dim row-parallel (its
    output reduced); a replicated leaf makes no collective.  The JAX
    layouts split the three together or none of them."""
    split = (mp is not None and mp.active and specs is not None
             and model_dim(specs["w1"]) == len(specs["w1"]) - 1)
    if split != (mp is not None and mp.active and specs is not None
                 and model_dim(specs["w2"]) == len(specs["w2"]) - 2):
        raise ValueError(f"mlp_apply: w1 {specs['w1']} and w2 "
                         f"{specs['w2']} must split d_ff together")
    xin = copy_to_model(x, mp) if split else x
    h = xin @ params["w1"]
    if act == "silu":
        h = F.silu(h) * (xin @ params["w3"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    out = h @ params["w2"]
    return reduce_from_model(out, mp) if split else out


def embed_init(generator, vocab, d_model, dtype=torch.float32):
    return {"table": dense_init(generator, (vocab, d_model), dtype,
                                scale=1.0)}


def sinusoidal_positions(n_pos, dim, dtype=torch.float32, device=None):
    """Whisper-style sinusoidal absolute position embeddings [n_pos, dim]:
    computed in float64 with numpy, then cast (the JAX package's table).
    The table is built once per (n_pos, dim, dtype, device) and kept, as
    JAX folds it into a constant: later forwards do no host work and no
    host-to-device copy.  Callers must not write into it."""
    return _sinusoidal_table(n_pos, dim, dtype, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=16)
def _sinusoidal_table(n_pos, dim, dtype, device):
    inv = np.exp(-np.log(10_000.0) * np.arange(dim // 2)
                 / max(dim // 2 - 1, 1))
    pos = np.arange(n_pos)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def sinusoidal_position_at(pos, dim, dtype=torch.float32):
    """The embedding [dim] of one position ``pos``, a 0-d int tensor, in
    float32 on ``pos``'s device (no host sync: a captured decode step reads
    ``pos`` there).  The JAX package's decode formula; at large positions
    it differs from :func:`sinusoidal_positions`' float64 table by more
    than an ulp, as in JAX."""
    half = dim // 2
    inv = torch.exp(-math.log(10_000.0)
                    * torch.arange(half, dtype=torch.float32,
                                   device=pos.device) / max(half - 1, 1))
    ang = pos.float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)
