"""Pluggable uplink/downlink compression for federated communication (port
of ``repro/compress``).

    identity            raw float32 (baseline)
    int8 / int4 / quant stochastic uniform quantization, per-leaf scale
                        (``quant`` reads ``FLConfig.quant_bits``)
    topk / topk_noef    top-k sparsification (+ client error feedback)
    mask / lowrank      seed-expanded random sketching (the port's own
                        seeded expansion, JAX's wire format)
"""
from repro_torch.compress.codec import Codec, IdentityCodec
from repro_torch.compress.quant import QuantCodec
from repro_torch.compress.sketch import SketchCodec
from repro_torch.compress.topk import TopKCodec
from repro_torch.configs.base import CODEC_NAMES

__all__ = ["CODEC_NAMES", "Codec", "IdentityCodec", "QuantCodec",
           "SketchCodec", "TopKCodec", "make_codec"]


def make_codec(name: str, *, topk_frac: float = 0.05,
               quant_bits: int = 8) -> Codec:
    """Build a codec by config name (see :data:`CODEC_NAMES`), with the
    same construction-time errors as the JAX package's ``make_codec``."""
    if name in ("topk", "topk_noef", "mask", "lowrank"):
        if not 0.0 < topk_frac <= 1.0:
            raise ValueError(
                f"codec {name!r}: topk_frac={topk_frac!r} must be in (0, 1]")
    if name == "quant" and quant_bits not in (4, 8):
        raise ValueError(
            f"codec 'quant': quant_bits={quant_bits!r} must be 4 or 8")
    if name == "identity":
        return IdentityCodec()
    if name == "quant":
        return QuantCodec(quant_bits)
    if name in ("int8", "int4"):
        return QuantCodec(int(name[3:]))
    if name == "topk":
        return TopKCodec(topk_frac, error_feedback=True)
    if name == "topk_noef":
        return TopKCodec(topk_frac, error_feedback=False)
    if name == "mask":
        return SketchCodec(topk_frac, mode="mask")
    if name == "lowrank":
        return SketchCodec(topk_frac, mode="lowrank")
    raise ValueError(f"unknown codec {name!r}; choose from {CODEC_NAMES}")
