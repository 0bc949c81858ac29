"""Seed-expanded random sketching: coordinate masks and low-rank projection
(port of ``repro/compress/sketch.py``).

Both modes transmit a dense buffer that is ``frac`` of the leaf plus one
int32 seed; the receiver re-expands the random operator from the seed, so
indices and projection matrices never cross the wire.

* ``mask``: a seeded random coordinate subset of size k = ceil(frac * n);
  transmitted values are scaled by n/k so the estimator is unbiased.
* ``lowrank``: matrix leaves X [m, n] send U = X G with G [n, r] Gaussian,
  G entries ~ N(0, 1/r); the receiver forms X_hat = U G^T, and E[X_hat] =
  X.  Non-matrix leaves fall back to ``mask``.

The wire format is the JAX package's: the same buffers, shapes and bytes
per leaf.  Conv weights (the port's 4-D leaves) are OIHW in the port and
HWIO on the wire, so a mask index counts positions of the HWIO leaf and
``lowrank`` projects JAX's ``[H*W*I, O]`` matrix.

The expansion is the port's own, since ``jax.random`` draws cannot be
redrawn in PyTorch: a counter-based hash of (seed, index) in int64 torch
ops, every product below 2**63 (:func:`hash_keys`, a four-round Feistel
network over two 31-bit halves, so a bijection: one seed gives every index
its own key, without ties).  It is a pure function of the seed tensor, so
the CPU and the card pick the same mask indices bit for bit, and a CUDA
graph replays it with a new staged seed.  ``mask`` keeps the k indices
with the smallest keys, ascending; ``lowrank`` draws G by Box-Muller from
two hashed uniforms per entry.  :meth:`SketchCodec._expand` is the one
place the operator is drawn (tests hand JAX's draws in there).

Each leaf's seed comes from the codec's noise (``uses_noise``,
``noise_sizes``: one uniform offset u per leaf, seed = int32(u * 2**31));
without noise leaf i takes seed i + 1, as JAX's codec does without a key.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compress.codec import Codec

__all__ = ["SketchCodec", "hash_keys"]

_M31 = (1 << 31) - 1
# odd multipliers below 2**32: a 31-bit value times one stays below 2**63
_MUL = (0x7FEB352D, 0x846CA68B)
_ROUND_KEYS = (0x2545F491, 0x6C8E9CF5, 0x1B873593, 0x5D588B65)
_U24 = 2.0 ** -24


def _round_fn(r, k):
    x = r ^ k
    x = (x * _MUL[0]) & _M31
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M31
    return x ^ (x >> 16)


def hash_keys(seed, counters):
    """62-bit int64 keys of ``counters`` (int64, each below 2**31) under
    ``seed`` (an int tensor of one element): a Feistel network with
    ``seed`` and the counter as its two 31-bit halves."""
    left = (seed.reshape(()).to(torch.int64) & _M31).expand_as(counters)
    right = counters
    for k in _ROUND_KEYS:
        left, right = right, left ^ _round_fn(right, k)
    return (left << 31) | right


def _uniform(keys):
    """Keys -> float32 uniforms in (0, 1) from their top 24 bits."""
    return ((keys >> 38).to(torch.float32) + 0.5) * _U24


class SketchCodec(Codec):
    """Random-mask / low-rank sketching; ``mode`` in {"mask", "lowrank"}."""

    stateful = False
    uses_noise = True

    def __init__(self, frac: float = 0.1, *, mode: str = "mask"):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"sketch frac={frac!r} must be in (0, 1]")
        if mode not in ("mask", "lowrank"):
            raise ValueError(f"sketch mode={mode!r} must be 'mask' or "
                             "'lowrank'")
        self.frac = frac
        self.mode = mode
        self.name = mode if mode == "lowrank" else "mask"

    # -- the leaf's wire view --------------------------------------------
    def _wire_shape(self, i):
        """Leaf ``i``'s shape in the JAX package's layout (conv weights
        HWIO)."""
        shape = self._shapes[i]
        if len(shape) == 4:
            o, ci, h, w = shape
            return (h, w, ci, o)
        return shape

    def _is_matrix(self, i) -> bool:
        shape = self._wire_shape(i)
        return (self.mode == "lowrank" and len(shape) >= 2
                and shape[-1] > 1 and self._n(i) // shape[-1] > 1)

    def _rank(self, i) -> int:
        return max(1, int(round(self.frac * self._wire_shape(i)[-1])))

    def _k(self, i) -> int:
        return max(1, min(self._n(i), math.ceil(self.frac * self._n(i))))

    def _to_wire(self, x, i):
        """Flat port leaf -> the leaf flat in the JAX package's layout."""
        if len(self._shapes[i]) == 4:
            x = x.reshape(self._shapes[i]).permute(2, 3, 1, 0)
        return x.reshape(-1)

    def _from_wire(self, x, i):
        """The leaf flat in the JAX package's layout -> flat port leaf."""
        if len(self._shapes[i]) == 4:
            x = x.reshape(self._wire_shape(i)).permute(3, 2, 0, 1)
        return x.reshape(-1)

    # -- the seeded operator ---------------------------------------------
    def noise_sizes(self):
        """One uniform offset per leaf: the leaf's seed."""
        return [1] * len(self._shapes)

    def _seed_from(self, noise, i):
        if noise is None:
            return torch.full((1,), i + 1, dtype=torch.int32,
                              device=self._device)
        return (noise.reshape(1) * 2.0 ** 31).to(torch.int32)

    def _expand(self, seed, i):
        """Leaf ``i``'s operator from its seed: the k mask indices
        (int64, ascending) or G [cols, r] (float32)."""
        dev = seed.device
        if self._is_matrix(i):
            cols, r = self._wire_shape(i)[-1], self._rank(i)
            t = torch.arange(cols * r, dtype=torch.int64, device=dev)
            u1 = _uniform(hash_keys(seed, 2 * t))
            u2 = _uniform(hash_keys(seed, 2 * t + 1))
            z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                (2.0 * math.pi) * u2)
            return z.reshape(cols, r) * (r ** -0.5)
        keys = hash_keys(seed, torch.arange(self._n(i), dtype=torch.int64,
                                            device=dev))
        idx = torch.topk(keys, self._k(i), largest=False,
                         sorted=False).indices
        return torch.sort(idx).values

    # -- encode / decode -------------------------------------------------
    def _encode_leaf(self, x, state, noise, i):
        seed = self._seed_from(noise, i)
        if self._is_matrix(i):
            u = (self._to_wire(x, i).reshape(-1, self._wire_shape(i)[-1])
                 @ self._expand(seed, i))
            return {"u": u, "seed": seed}, state
        n, k = self._n(i), self._k(i)
        val = self._to_wire(x, i)[self._expand(seed, i)] * (n / k)
        return {"mval": val.to(torch.float32), "seed": seed}, state

    def _decode_leaf(self, payload, i):
        seed = payload["seed"]
        if self._is_matrix(i):
            g = self._expand(seed, i)
            return self._from_wire(payload["u"] @ g.T, i)
        dense = torch.zeros(self._n(i), device=payload["mval"].device)
        return self._from_wire(
            dense.index_copy(0, self._expand(seed, i), payload["mval"]), i)

    def _leaf_wire_bytes(self, i) -> int:
        if self._is_matrix(i):
            rows = self._n(i) // self._wire_shape(i)[-1]
            return 4 * rows * self._rank(i) + 4
        return 4 * self._k(i) + 4
