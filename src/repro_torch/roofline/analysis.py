"""Three-term roofline from an op record (port of
``repro/roofline/analysis.py``).

The terms come from the cost model (:mod:`repro_torch.roofline.cost`)
over a record of one step (:mod:`repro_torch.analysis.records`); the
record holds this rank's shapes, so every term is per card:

    compute    = flops_per_chip / PEAK_FLOPS
    memory     = hbm_bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / LINK_BW

The peaks are the datasheet figures of the card the port runs on, NVIDIA
H100 80GB HBM3 (SXM, 700.00 W), not measurements: float32 outside the
tensor cores (TF32 stays off in the port), HBM3's bandwidth, and one
direction of NVLink 4, which stands in for the JAX package's ICI term.
The hosts the port is measured on have one card, so the collective term
cannot be checked against a measurement there.

MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); the two-stream
algorithms add a frozen-global forward (+2 N D), counted in
MODEL_FLOPS_2STREAM, so the useful ratio separates genuine technique
overhead from waste.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.specs import fl_plan
from repro_torch.roofline.cost import analyze_record

PEAK_FLOPS = 67e12         # float32 (no tensor cores) per card, H100 SXM
HBM_BW = 3.35e12           # bytes/s per card, HBM3
LINK_BW = 450e9            # bytes/s per card per direction, NVLink 4


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0
    model_flops_2stream: float = 0.0
    peak_memory_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the dominant term."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_ratio=self.useful_ratio, mfu_bound=self.mfu_bound)
        return d


def model_flops(cfg: ArchConfig, shape: InputShape, mesh,
                two_stream: bool = True) -> Dict[str, float]:
    n = cfg.active_param_count()
    if shape.kind == "train":
        plan = fl_plan(cfg, shape, mesh)
        tokens = (plan.n_clients * plan.local_steps * plan.client_batch
                  * shape.seq_len)
        base = float(6 * n * tokens)
        return {"model_flops": base,
                "model_flops_2stream": base + (2.0 * n * tokens
                                               if two_stream else 0.0)}
    if shape.kind == "prefill":
        f = float(2 * n * shape.global_batch * shape.seq_len)
    else:
        f = float(2 * n * shape.global_batch)   # decode: 1 token/seq
    return {"model_flops": f, "model_flops_2stream": f}


def analyze(record, cfg: ArchConfig, shape: InputShape, mesh_name: str,
            chips: int, mesh=None, two_stream: bool = True) -> Roofline:
    """The roofline of one rank's recorded step."""
    cost = analyze_record(record)
    mf = model_flops(cfg, shape, mesh, two_stream)
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_chip=cost.flops,
        hbm_bytes_per_chip=cost.bytes,
        coll_bytes_per_chip=cost.total_coll_bytes,
        coll_breakdown=dict(cost.coll_bytes),
        coll_counts=dict(cost.coll_counts),
        model_flops=mf["model_flops"],
        model_flops_2stream=mf["model_flops_2stream"],
        peak_memory_bytes=float(record.peak_bytes))
