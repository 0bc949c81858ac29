"""Stochastic int8 / int4 uniform quantization with per-leaf scale (port
of ``repro/compress/quant.py``).

Per leaf: scale = max(max|x|, 1e-12) / qmax, codes = clip(floor(x/scale +
u), +-qmax) with u the caller's uniform offsets (unbiased stochastic
rounding; u = 0.5 without noise).  int4 codes are nibble-packed two per
byte, so the wire payload is n/8 of float32.  The scale stays on the
device as a one-element tensor: no host sync.  On the card a message
encodes with two K3 launches for all its leaves, scales included
(``repro_torch.kernels.compress_pack.quant_pack_multi``), and decodes with
one K4 launch (``quant_unpack_multi``).

Level ladder (``set_ladder``, bits in (4, 8), top = the codec's bits): the
effective bits enter through the scale only, ``max|x| / qmax_table[level]``
with qmax 2**(b - 1) - 1, so the codes span +-qmax at the level and always
fit the capacity packing.  K3 reads the level on the device (two launches
a message at any level).
"""
from __future__ import annotations

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

    def _encode_leaves(self, leaves, state, noise, level=None):
        coded = compress_pack.quant_pack_multi(
            leaves, [u if u is None else u.contiguous() for u in noise],
            bits=self.bits, level=level,
            ladder_qmax=None if level is None else self._qmax_table())
        return [{"q": q, "scale": s} for q, s in coded], list(state)

    def _decode_leaves(self, payload):
        return compress_pack.quant_unpack_multi(
            [p["q"] for p in payload], [p["scale"] for p in payload],
            bits=self.bits, ns=[self._n(i) for i in range(len(payload))])

    def _leaf_wire_bytes(self, i) -> int:
        pn = self.padded_n(i)
        return (pn if self.bits == 8 else pn // 2) + 4   # codes + f32 scale

    # -- level ladder ---------------------------------------------------
    def set_ladder(self, values):
        vals = tuple(int(v) for v in values)
        if not vals or list(vals) != sorted(set(vals)):
            raise ValueError(f"ladder {values!r} must be strictly ascending")
        if not all(v in (4, 8) for v in vals):
            raise ValueError(f"ladder {values!r} needs bits in (4, 8)")
        if vals[-1] != self.bits:
            raise ValueError(f"ladder top {vals[-1]} must equal the codec's "
                             f"capacity bits {self.bits}")
        self._ladder = vals
        return self

    def _qmax_table(self):
        if self._ladder is None:
            raise ValueError("set_ladder first")
        return tuple(float(2 ** (b - 1) - 1) for b in self._ladder)

    def level_bytes(self):
        if self._ladder is None:
            raise ValueError("set_ladder first")
        out = []
        for b in self._ladder:
            total = 0
            for i in range(len(self._shapes)):
                n = self._n(i)
                total += (n + n % 2) // 2 if b == 4 else n
                total += 4  # fp32 scale
            out.append(total)
        return tuple(out)
