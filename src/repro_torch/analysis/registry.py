"""Pass registry for the static invariant analyzer (port of
``repro/analysis/registry.py``).

``register_pass`` / ``make_pass`` / ``registered_passes`` mirror the
port's other plugin registries (``repro_torch.compress.make_codec``,
``repro_torch.fl.api.make_algorithm``,
``repro_torch.control.make_controller``): a pass is a small class
registered by name, and the runner instantiates every requested pass
fresh per run.

Two pass scopes exist:

* ``scope = "lowered"``: the pass receives a
  :class:`repro_torch.analysis.lower.LoweredSuperstep` per config point
  and inspects its op records (``needs_capture = True``: the pass must see
  the card's CUDA-graph capture of the chunk, where one was made);
* ``scope = "source"``: the pass runs once per analysis over the
  ``src/repro_torch`` tree (AST lint).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Type


class AnalysisFailure(RuntimeError):
    """An analysis run could not be carried out (not a finding)."""


@dataclass
class Finding:
    """One invariant violation.

    ``point`` names where it was found: a config-point id for lowered
    passes, a ``path:line`` for source passes.
    """
    pass_name: str
    point: str
    message: str
    severity: str = "error"

    def to_json(self) -> Dict:
        return {"pass": self.pass_name, "point": self.point,
                "message": self.message, "severity": self.severity}

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.point}: {self.message}"


class AnalysisPass:
    """Base class for invariant passes.

    Subclasses set ``name`` (registry key), ``scope`` ("lowered" |
    "source"), ``needs_capture`` (lowered passes that read the card's
    capture of the chunk, not just the op record) and implement
    ``run(target) -> List[Finding]``.
    """
    name: str = ""
    scope: str = "lowered"
    needs_capture: bool = False
    description: str = ""

    def run(self, target) -> List[Finding]:
        raise NotImplementedError

    def finding(self, point: str, message: str, *,
                severity: str = "error") -> Finding:
        return Finding(self.name, point, message, severity=severity)


_PASSES: Dict[str, Type[AnalysisPass]] = {}


def register_pass(cls: Type[AnalysisPass]) -> Type[AnalysisPass]:
    """Class decorator: register an :class:`AnalysisPass` by its name."""
    if not (isinstance(cls, type) and issubclass(cls, AnalysisPass)):
        raise TypeError(f"register_pass expects an AnalysisPass subclass, "
                        f"got {cls!r}")
    if not cls.name:
        raise ValueError(f"{cls.__name__}.name must be a non-empty string")
    if cls.scope not in ("lowered", "source"):
        raise ValueError(f"{cls.__name__}.scope must be 'lowered' or "
                         f"'source', got {cls.scope!r}")
    if cls.name in _PASSES and _PASSES[cls.name] is not cls:
        raise ValueError(f"analysis pass {cls.name!r} already registered "
                         f"by {_PASSES[cls.name].__name__}")
    _PASSES[cls.name] = cls
    return cls


def make_pass(name: str, **kwargs) -> AnalysisPass:
    """Instantiate a registered pass by name."""
    if name not in _PASSES:
        raise KeyError(f"unknown analysis pass {name!r}; registered: "
                       f"{registered_passes()}")
    return _PASSES[name](**kwargs)


def registered_passes() -> Tuple[str, ...]:
    """Sorted names of every registered pass."""
    return tuple(sorted(_PASSES))
