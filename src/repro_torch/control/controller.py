"""Adaptive compression controllers inside the superstep (port of
``repro/control/controller.py``).

A :class:`Controller` is the decision rule that retunes the uplink codec
round over round inside the engine's chunk, with no host round-trip.  Its
state (a small dict of 0-d float32 / int32 tensors) is carried through the
superstep like the EF table and the downlink mirror: on the card its
tensors are static buffers of the captured graph, updated in place at the
end of each replay.  Its ``update`` hook runs after the round's sums,
reading the telemetry signals the round already computed
(``tele/ef_delta_ratio``, ``local_loss``, ...) and emitting the NEXT
round's effective compression level, in torch ops on 0-d tensors (no
``.item()``, no tensor made from host data: it runs inside a capture).

Because wire shapes stay static, "retuning the codec" means selecting a
level on a discrete **ladder** of codec configurations: the codec is bound
once at the ladder's top (capacity) level and the device-side ``level``
masks the payload down to the effective configuration
(``repro_torch.compress``: top-k rank masking, quant effective-qmax
scaling).  What would cross a real network is the effective per-level byte
count, which ``LadderSpec.bytes_up`` carries and ``CommLog`` charges per
round.

Contracts:

* ``controller="static"`` is the bitwise oracle: the engine takes the
  exact pre-controller code path (no ladder, no controller state).
* Controller state checkpoints to ``ctrl.npz`` next to ``ef.npz``;
  interrupt + resume is bit-equal to an uninterrupted run.
* On a mesh the update reads only the round's all-reduced metrics and
  runs on every rank: it adds no collective, and the state stays the
  same on every rank (replicated, like the global model).

Registered like every other plugin axis: ``register_controller`` /
``make_controller`` / ``registered_controllers``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

__all__ = ["LadderSpec", "Controller", "StaticController",
           "EFRatioController", "BytesBudgetController",
           "LossTrendController", "register_controller", "make_controller",
           "registered_controllers", "ladder_kind", "ladder_values",
           "LADDER_CODECS"]

# uplink codecs that support a level ladder (Codec.set_ladder)
LADDER_CODECS = ("topk", "topk_noef", "quant", "int8", "int4")

# loss_trend: relative EMA-loss improvement below this reads as a plateau
_TREND_THRESH = 0.01

_F32, _I32 = torch.float32, torch.int32


def ladder_kind(uplink_codec: str) -> str:
    """The ladder's parameter axis for a codec name."""
    if uplink_codec in ("topk", "topk_noef"):
        return "topk_frac"
    if uplink_codec in ("quant", "int8", "int4"):
        return "quant_bits"
    raise ValueError(
        f"uplink codec {uplink_codec!r} has no compression ladder; "
        f"adaptive controllers support {LADDER_CODECS}")


def ladder_values(fl) -> Tuple[float, ...]:
    """The run's ladder (ascending effective levels, top = capacity).

    ``fl.ladder`` when given — validated against the uplink codec family
    and required to top out at the configured static parameter (so level
    ``n_levels-1`` IS the configured codec, and the wire capacity equals
    the static run's).  Empty defaults to a 3-level top-k ladder
    ``(f/4, f/2, f)`` or the quant ladder ``(4, 8)`` / ``(4,)``.
    """
    kind = ladder_kind(fl.uplink_codec)
    # the capacity the codec binds at: int8/int4 fix their bits by name;
    # "quant" reads fl.quant_bits
    cap = (int(fl.uplink_codec[3:]) if fl.uplink_codec in ("int8", "int4")
           else int(getattr(fl, "quant_bits", 8)))
    vals = tuple(fl.ladder)
    if not vals:
        if kind == "topk_frac":
            f = fl.topk_frac
            return (f / 4.0, f / 2.0, f)
        return (4, 8) if cap == 8 else (4,)
    if list(vals) != sorted(vals) or len(set(vals)) != len(vals):
        raise ValueError(f"ladder {vals} must be strictly ascending")
    if kind == "topk_frac":
        if not all(0.0 < v <= 1.0 for v in vals):
            raise ValueError(f"topk ladder {vals} needs fracs in (0, 1]")
        if vals[-1] != fl.topk_frac:
            raise ValueError(
                f"ladder top {vals[-1]} must equal topk_frac="
                f"{fl.topk_frac} (the codec binds at capacity)")
    else:
        if not all(v in (4, 8) for v in vals):
            raise ValueError(f"quant ladder {vals} needs bits in (4, 8)")
        if int(vals[-1]) != cap:
            raise ValueError(
                f"ladder top {vals[-1]} must equal the uplink codec's "
                f"capacity bits {cap} (the codec binds at capacity)")
    return vals


@dataclass(frozen=True)
class LadderSpec:
    """The discrete level ladder one run compresses along.

    ``values`` ascends (cheapest level 0 -> capacity); ``bytes_up`` is the
    effective per-client uplink payload bytes at each level (from
    ``Codec.level_bytes()``: what a real wire would carry, used by the
    CommLog accounting and the bytes-budget controller).
    """

    kind: str                       # "topk_frac" | "quant_bits"
    values: Tuple[float, ...]
    bytes_up: Tuple[int, ...]

    def __post_init__(self):
        if len(self.values) != len(self.bytes_up):
            raise ValueError("values / bytes_up length mismatch")
        if not self.values:
            raise ValueError("a ladder needs at least one level")

    @property
    def n_levels(self) -> int:
        return len(self.values)

    def bytes_table(self, device=None) -> torch.Tensor:
        """[n_levels] float32 effective-bytes lookup on ``device``."""
        return torch.tensor(self.bytes_up, dtype=_F32, device=device)


def take(table: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """``table[level]`` for a 0-d int32 device ``level``, as a 0-d tensor,
    without reading the level on the host."""
    return table.index_select(0, level.reshape(1)).reshape(())


class Controller:
    """Base controller: subclass, set ``name``/``requires_taps``,
    implement ``init_state``/``update``.

    ``update(state, metrics)`` runs inside the round, after the clients'
    sums: ``metrics`` is the round's metric dict (``local_loss`` plus the
    active ``tele/...`` signals, 0-d tensors), and the returned state dict
    keeps the incoming keys and dtypes (it is copied into the carried
    buffers).  ``state["level"]`` is the contract key: the level the NEXT
    round encodes at.  ``requires_taps`` names the telemetry taps whose
    signals ``update`` reads; the engine forces them on.
    """

    name: str = "?"
    requires_taps: Tuple[str, ...] = ()

    def __init__(self):
        self.spec: LadderSpec = None  # bound by setup()

    def setup(self, spec: LadderSpec, fl, device=None) -> "Controller":
        """Bind the run's ladder, knobs and device (called once by the
        engine, before any capture: the bytes table is made here)."""
        self.spec = spec
        self.band = tuple(getattr(fl, "ctrl_band", (0.5, 2.0)))
        self.ema = float(getattr(fl, "ctrl_ema", 0.8))
        self.budget_frac = float(getattr(fl, "ctrl_budget_frac", 0.5))
        self.device = torch.device("cpu" if device is None else device)
        self._bytes = spec.bytes_table(self.device)
        return self

    def bytes_table(self) -> torch.Tensor:
        """The ladder's [n_levels] float32 bytes on the bound device."""
        return self._bytes

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def _clip(self, level) -> torch.Tensor:
        return torch.clamp(level, 0, self.spec.n_levels - 1).to(_I32)

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {"level": self._scalar(self.spec.n_levels - 1, _I32)}

    def update(self, state: Dict[str, torch.Tensor],
               metrics: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return state


class StaticController(Controller):
    """The configured codec every round.  The engine takes the exact
    pre-controller code path for this name (no ladder, no controller state
    in the chunk): the bitwise oracle."""

    name = "static"


class EFRatioController(Controller):
    """Track ``tele/ef_delta_ratio`` (EF residual mass / delta mass) in a
    band: a ratio EMA above the band means the codec defers too much
    update -> loosen one level; below it there is headroom -> tighten one
    level.  Starts at level 0 (cheapest)."""

    name = "ef_ratio"
    requires_taps = ("ef",)

    def init_state(self):
        return {"level": self._scalar(0, _I32),
                "ema": self._scalar(0.0, _F32)}

    def update(self, state, metrics):
        ratio = metrics["tele/ef_delta_ratio"].to(_F32)
        a = torch.full((), self.ema, dtype=_F32, device=ratio.device)
        ema = a * state["ema"] + (1.0 - a) * ratio
        lo, hi = self.band
        step = (ema > hi).to(_I32) - (ema < lo).to(_I32)
        return {"level": self._clip(state["level"] + step), "ema": ema}


class BytesBudgetController(Controller):
    """Feedback to a cumulative uplink-bytes target: spend at most
    ``ctrl_budget_frac`` of the capacity level's bytes per round on
    average.  Over budget -> tighten, under -> loosen; the running spend is
    carried in the controller state, so the rule needs no host
    accounting."""

    name = "bytes_budget"

    def init_state(self):
        return {"level": self._scalar(0, _I32),
                "spent": self._scalar(0.0, _F32),
                "rounds": self._scalar(0.0, _F32)}

    def update(self, state, metrics):
        spent = state["spent"] + take(self.bytes_table(), state["level"])
        rounds = state["rounds"] + 1.0
        budget = torch.full((), self.budget_frac * self.spec.bytes_up[-1],
                            dtype=_F32, device=spent.device)
        step = torch.where(spent > budget * rounds, -1, 1).to(_I32)
        return {"level": self._clip(state["level"] + step),
                "spent": spent, "rounds": rounds}


class LossTrendController(Controller):
    """Loosen when the loss plateaus, stay cheap while it still falls: an
    EMA of the round loss is compared with its previous value, and a
    relative improvement under 1% reads as a plateau (one level up)."""

    name = "loss_trend"

    def init_state(self):
        return {"level": self._scalar(0, _I32),
                "ema": self._scalar(0.0, _F32),
                "seen": self._scalar(0.0, _F32)}

    def update(self, state, metrics):
        loss = metrics["local_loss"].to(_F32)
        a = torch.full((), self.ema, dtype=_F32, device=loss.device)
        first = state["seen"] < 0.5
        ema = torch.where(first, loss, a * state["ema"] + (1.0 - a) * loss)
        rel = (state["ema"] - ema) / torch.clamp_min(ema.abs(), 1e-8)
        step = torch.where(rel < _TREND_THRESH, 1, -1).to(_I32)
        lvl = self._clip(state["level"]
                         + torch.where(first, 0, step).to(_I32))
        return {"level": lvl, "ema": ema, "seen": state["seen"] + 1.0}


# --------------------------------------------------------------------------
# Registry (mirrors repro_torch.fl.participation / repro_torch.fl.api)
# --------------------------------------------------------------------------

Factory = Callable[[], Controller]

_REGISTRY: Dict[str, Factory] = {
    "static": StaticController,
    "ef_ratio": EFRatioController,
    "bytes_budget": BytesBudgetController,
    "loss_trend": LossTrendController,
}


def register_controller(name: str, factory: Factory, *,
                        overwrite: bool = False) -> None:
    """Add a controller to the registry (plugins call this like
    ``register_policy`` / ``register_algorithm``)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"controller {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def make_controller(name: str) -> Controller:
    """Instantiate a registered controller by name (unbound: the engine
    calls ``setup(spec, fl, device)`` with the run's ladder)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown controller {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def registered_controllers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
