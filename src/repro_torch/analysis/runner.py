"""Drive a set of passes over a config matrix and collect a report (port
of ``repro/analysis/runner.py``)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.lower import (SuperstepSpec, default_matrix,
                                        lower_superstep)
from repro_torch.analysis.registry import (AnalysisFailure, Finding,
                                           make_pass, registered_passes)

SOURCE_POINT = "src/repro_torch"


@dataclass
class Report:
    """Outcome of one analysis run.

    ``points`` maps each lowered config point to the pass names that ran
    on it; ``findings`` is every violation; ``errors`` records points
    that could not be analyzed at all (infra failures, NOT invariant
    violations — they still fail the run)."""
    passes: List[str] = field(default_factory=list)
    points: Dict[str, List[str]] = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)
    errors: List[Dict] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_json(self) -> Dict:
        return {"ok": self.ok, "passes": list(self.passes),
                "n_points": len(self.points), "points": dict(self.points),
                "findings": [f.to_json() for f in self.findings],
                "errors": list(self.errors),
                "elapsed_s": round(self.elapsed_s, 3)}

    @staticmethod
    def from_json(data: Dict) -> "Report":
        return Report(
            passes=data.get("passes", []), points=data.get("points", {}),
            findings=[Finding(d["pass"], d["point"], d["message"],
                              severity=d.get("severity", "error"))
                      for d in data.get("findings", [])],
            errors=data.get("errors", []),
            elapsed_s=data.get("elapsed_s", 0.0))

    def merged(self, other: "Report") -> "Report":
        findings = list(self.findings)
        findings += [f for f in other.findings if f not in findings]
        return Report(
            passes=sorted(set(self.passes) | set(other.passes)),
            points={**self.points, **other.points},
            findings=findings,
            errors=self.errors + other.errors,
            elapsed_s=self.elapsed_s + other.elapsed_s)


def run_analysis(specs: Optional[Sequence[SuperstepSpec]] = None,
                 passes: Optional[Sequence[str]] = None,
                 preset: str = "quick", *, device=None,
                 shard=None) -> Report:
    """Run ``passes`` (default: all registered) over ``specs`` (default:
    :func:`default_matrix` at ``preset``), lowering each point on
    ``device`` (the card unless another device is named) and its sharded
    points over ``shard`` (default: every rank of the default process
    group).

    Lowered passes run per config point; source passes run once.  Infra
    failures at a point are recorded as errors and the remaining points
    still run.
    """
    t0 = time.perf_counter()
    names = list(passes) if passes else list(registered_passes())
    unknown = [n for n in names if n not in registered_passes()]
    if unknown:
        raise AnalysisFailure(f"unknown pass(es) {unknown}; registered: "
                              f"{registered_passes()}")
    instances = [make_pass(n) for n in names]
    lowered_passes = [p for p in instances if p.scope == "lowered"]
    source_passes = [p for p in instances if p.scope == "source"]
    rep = Report(passes=names)

    for p in source_passes:
        rep.points[SOURCE_POINT] = sorted(
            set(rep.points.get(SOURCE_POINT, [])) | {p.name})
        try:
            rep.findings.extend(p.run(None))
        except Exception as e:  # infra failure, not a finding
            rep.errors.append({"point": SOURCE_POINT, "pass": p.name,
                               "error": f"{type(e).__name__}: {e}"})

    if lowered_passes:
        if specs is None:
            specs = default_matrix(preset)
        for spec in specs:
            try:
                low = lower_superstep(spec, device=device, shard=shard)
            except Exception as e:
                rep.errors.append({"point": spec.point, "pass": "lower",
                                   "error": f"{type(e).__name__}: {e}"})
                continue
            rep.points[low.point] = [p.name for p in lowered_passes]
            for p in lowered_passes:
                try:
                    rep.findings.extend(p.run(low))
                except Exception as e:
                    rep.errors.append(
                        {"point": low.point, "pass": p.name,
                         "error": f"{type(e).__name__}: {e}"})
    rep.elapsed_s = time.perf_counter() - t0
    return rep
