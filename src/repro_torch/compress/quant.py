"""Stochastic int8 / int4 uniform quantization with per-leaf scale (port
of ``repro/compress/quant.py``, without the ``level=`` ladder).

Per leaf: scale = max(max|x|, 1e-12) / qmax, codes = clip(floor(x/scale +
u), +-qmax) with u the caller's uniform offsets (unbiased stochastic
rounding; u = 0.5 without noise).  int4 codes are nibble-packed two per
byte, so the wire payload is n/8 of float32.  The scale stays on the
device as a one-element tensor: no host sync.  Quantize + pack runs K3
once per leaf, and a message decodes with one K4 launch for all its leaves
(``repro_torch.kernels.compress_pack.quant_unpack_multi``) on the card.
"""
from __future__ import annotations

import torch

from repro_torch.compress.codec import Codec
from repro_torch.kernels import compress_pack


class QuantCodec(Codec):
    """Stochastic uniform quantizer; ``bits`` in {4, 8}."""

    stateful = False
    uses_noise = True

    def __init__(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError(f"quant bits={bits!r} must be 4 or 8")
        self.bits = bits
        self.name = f"int{bits}"

    def padded_n(self, i) -> int:
        """Element count of leaf ``i`` as packed: odd counts are padded to
        even for int4.  Offsets handed to ``encode`` have this length."""
        n = self._n(i)
        return n + (n % 2 if self.bits == 4 else 0)

    def noise_sizes(self):
        """The length of each leaf's offsets for ``encode``."""
        return [self.padded_n(i) for i in range(len(self._shapes))]

    def _encode_leaf(self, x, state, noise, i):
        pn = self.padded_n(i)
        if pn != x.shape[0]:
            x = torch.nn.functional.pad(x, (0, pn - x.shape[0]))
        qmax = 127 if self.bits == 8 else 7
        scale = (x.abs().amax().clamp_min(1e-12) / qmax).reshape(1)
        if noise is None:
            noise = torch.full((pn,), 0.5, device=x.device)
        packed = compress_pack.quant_pack(x, scale, noise.contiguous(),
                                          bits=self.bits)
        return {"q": packed, "scale": scale}, state

    def _decode_leaves(self, payload):
        return compress_pack.quant_unpack_multi(
            [p["q"] for p in payload], [p["scale"] for p in payload],
            bits=self.bits, ns=[self._n(i) for i in range(len(payload))])

    def _leaf_wire_bytes(self, i) -> int:
        pn = self.padded_n(i)
        return (pn if self.bits == 8 else pn // 2) + 4   # codes + f32 scale
