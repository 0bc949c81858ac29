"""The cost model and the roofline (port of ``repro/roofline``).
``PEAK_F32_FLOPS`` / ``PEAK_BYTES`` name the card's float32 and HBM peaks
where a kernel's bound is computed (``chip_smoke.py``)."""
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW,  # noqa: F401
                                           PEAK_FLOPS, Roofline, analyze,
                                           model_flops)
from repro_torch.roofline.cost import (Cost, analyze_record,  # noqa: F401
                                       collective_bytes,
                                       collective_op_counts,
                                       collective_summary, flops_breakdown,
                                       op_cost)

PEAK_F32_FLOPS = PEAK_FLOPS
PEAK_BYTES = HBM_BW
