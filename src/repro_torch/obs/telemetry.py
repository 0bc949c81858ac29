"""On-device telemetry taps for the federated round functions (port of
``repro/obs/telemetry.py``).

The signals the adaptive-compression controllers and capacity planning
read — delta norms before and after the wire codec, EF residual mass, the
residual/delta ratio, compression error, the round's example total — are
computed on the device every round by *taps*: small hooks the round
factories in ``repro_torch.core.rounds`` evaluate beside training, whose
outputs join the round's metrics and so ride the superstep's stacked
``[K]`` metrics and the ``MetricsPump`` like every other metric.  Every
tap value is a 0-d float32 tensor and no tap reads a value on the host,
so taps run inside a captured CUDA graph and add no host sync.

Tap protocol (registered like algorithm and codec plugins):

* ``client_sums(ctx)`` runs once per client and returns a flat ``{key:
  0-d float32 tensor}`` dict of sums that are added over the round's
  clients before finalization.  Keys are namespaced ``"{tap.name}.{key}"``.
  On a mesh each rank adds its own clients' sums and they ride the
  round's all-reduce (the fused round's one buffer, or the unfused
  round's per-leaf all-reduces): taps add no collective of their own.
* ``finish(summed, ctx)`` maps the summed values to the emitted metrics
  (prefix ``tele/``): ratios and normalizations belong here, never in
  ``client_sums`` (a quotient does not sum).

``kinds`` declares which round flavours a tap understands (``"plain"`` /
``"compressed"``) and ``requires`` which :class:`ClientTapCtx` fields it
reads, so :func:`make_telemetry` only activates taps whose inputs exist
(the EF tap needs a stateful uplink).  Taps only read tensors the round
computes anyway, so a telemetry-on run is bit-equal to a telemetry-off
run.  A tree's sum of squares is one ``torch._foreach_norm`` over its
leaves (squared and added), not one reduction per leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves

__all__ = ["ClientTapCtx", "RoundTapCtx", "TelemetryTap", "Telemetry",
           "register_tap", "registered_taps", "make_telemetry",
           "TELEMETRY_PREFIX"]

TELEMETRY_PREFIX = "tele/"

# guards the residual/delta ratio against a zero-delta round; f32 tiny
_EPS = 1e-20

_F32 = torch.float32


def _sq_sum(tree) -> torch.Tensor:
    """Sum of x² over every leaf of a tree, as one 0-d float32 tensor."""
    leaves = [x.float() for x in tree_leaves(tree) if x is not None]
    return torch.stack(torch._foreach_norm(leaves)).square().sum()


def _diff_sq_sum(a, b) -> torch.Tensor:
    """Sum of (a - b)² over the leaves of two trees of one structure."""
    return _sq_sum(torch._foreach_sub([x.float() for x in tree_leaves(a)],
                                      [y.float() for y in tree_leaves(b)]))


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(_F32)


@dataclass(frozen=True)
class ClientTapCtx:
    """What one client's round computation exposes to ``client_sums``.

    Fields are None when the round flavour does not produce them; a tap
    lists the ones it reads in ``requires`` and is skipped when any is
    unavailable.
    """

    n_examples: Any = None      # 0-d — this client's (weighted) example count
    loss: Any = None            # 0-d — local training loss
    model: Any = None           # tree — trained local model (plain)
    global_model: Any = None    # tree — the model clients started from
    delta: Any = None           # tree — PRE-compression update (compressed)
    decoded: Any = None         # tree — POST-compression decoded update
    ef: Any = None              # list — the client's NEW EF residual
    pmask: Any = None           # 0-d — 0/1 participation mask
    staleness: Any = None       # 0-d — rounds late (participation)
    level: Any = None           # 0-d int32 — effective ladder level
    eff_bytes: Any = None       # 0-d — effective uplink payload bytes


@dataclass(frozen=True)
class RoundTapCtx:
    """Round-level statics available to ``finish`` (no tensors)."""

    n_clients: int = 1          # C — the FULL round's sampled clients
    n_shards: int = 1           # client shards the round runs across


class TelemetryTap:
    """Base tap: subclass, set ``name``/``kinds``/``requires``, implement
    the two hooks.  Stateless: one instance serves every round fn."""

    name: str = "?"
    kinds: Tuple[str, ...] = ("plain", "compressed")
    requires: Tuple[str, ...] = ()

    def client_sums(self, ctx: ClientTapCtx) -> Dict[str, torch.Tensor]:
        return {}

    def finish(self, summed: Dict[str, torch.Tensor],
               ctx: RoundTapCtx) -> Dict[str, torch.Tensor]:
        return {}


class DeltaNormTap(TelemetryTap):
    """RMS per-client update norm before and after the uplink codec, plus
    the compression error between them."""

    name = "delta"
    kinds = ("compressed",)
    requires = ("delta", "decoded")

    def client_sums(self, ctx):
        return {"pre_sq": _sq_sum(ctx.delta),
                "post_sq": _sq_sum(ctx.decoded),
                "err_sq": _diff_sq_sum(ctx.delta, ctx.decoded)}

    def finish(self, summed, ctx):
        c = float(ctx.n_clients)
        return {"delta_norm_pre": torch.sqrt(summed["delta.pre_sq"] / c),
                "delta_norm_post": torch.sqrt(summed["delta.post_sq"] / c),
                "compress_err": torch.sqrt(summed["delta.err_sq"] / c)}


class EFResidualTap(TelemetryTap):
    """RMS error-feedback residual norm and the residual/delta mass ratio:
    how much update the codec defers round over round."""

    name = "ef"
    kinds = ("compressed",)
    requires = ("ef", "delta")

    def client_sums(self, ctx):
        # carries its own delta mass so the tap works standalone
        return {"sq": _sq_sum(ctx.ef), "delta_sq": _sq_sum(ctx.delta)}

    def finish(self, summed, ctx):
        c = float(ctx.n_clients)
        return {"ef_norm": torch.sqrt(summed["ef.sq"] / c),
                "ef_delta_ratio": torch.sqrt(
                    summed["ef.sq"]
                    / torch.clamp_min(summed["ef.delta_sq"], _EPS))}


class UpdateNormTap(TelemetryTap):
    """RMS per-client drift of the trained local model from the global
    one (the uncompressed round's analogue of the delta norm)."""

    name = "update"
    kinds = ("plain",)
    requires = ("model", "global_model")

    def client_sums(self, ctx):
        return {"sq": _diff_sq_sum(ctx.model, ctx.global_model)}

    def finish(self, summed, ctx):
        return {"update_norm": torch.sqrt(
            summed["update.sq"] / float(ctx.n_clients))}


class WeightTap(TelemetryTap):
    """The round's aggregate example total (the FedAvg normalizer) and
    the per-shard client count."""

    name = "weights"
    kinds = ("plain", "compressed")
    requires = ("n_examples",)

    def client_sums(self, ctx):
        return {"total": _f32(ctx.n_examples)}

    def finish(self, summed, ctx):
        total = summed["weights.total"]
        return {"weight_total": total,
                "clients": torch.full_like(total, float(ctx.n_clients)),
                "clients_per_shard": torch.full_like(
                    total, float(ctx.n_clients // max(ctx.n_shards, 1)))}


class ParticipationTap(TelemetryTap):
    """Partial-cohort health: how many of the sampled lanes contributed,
    how many were dropped or late, and the mean staleness of the
    contributions that landed.  Active only when the participation axis is
    on (the engine adds ``pmask`` / ``staleness`` to ``available``)."""

    name = "participation"
    kinds = ("plain", "compressed")
    requires = ("pmask", "staleness")

    def client_sums(self, ctx):
        m = _f32(ctx.pmask)
        return {"arrived": m, "stale_sum": _f32(ctx.staleness) * m}

    def finish(self, summed, ctx):
        arrived = summed["participation.arrived"]
        return {"effective_cohort": arrived,
                "dropped_clients": float(ctx.n_clients) - arrived,
                "mean_staleness": summed["participation.stale_sum"]
                / torch.clamp_min(arrived, 1.0)}


class ControllerTap(TelemetryTap):
    """The adaptive-compression schedule (``repro_torch.control``): the
    round's effective ladder level and per-client effective uplink payload
    bytes.  Every client of a round encodes at the same level, so the mean
    is exact.  Active only when a controller is on (the engine adds
    ``level`` / ``eff_bytes`` to ``available``)."""

    name = "controller"
    kinds = ("compressed",)
    requires = ("level", "eff_bytes")

    def client_sums(self, ctx):
        return {"level": _f32(ctx.level), "bytes": _f32(ctx.eff_bytes)}

    def finish(self, summed, ctx):
        c = float(ctx.n_clients)
        return {"level": summed["controller.level"] / c,
                "effective_bytes": summed["controller.bytes"] / c}


_TAPS: Dict[str, TelemetryTap] = {}


def register_tap(tap: TelemetryTap) -> TelemetryTap:
    """Add a tap to the registry; re-registering a name replaces it."""
    if not tap.name or tap.name == "?":
        raise ValueError("telemetry taps need a non-default name")
    _TAPS[tap.name] = tap
    return tap


def registered_taps() -> Tuple[str, ...]:
    return tuple(sorted(_TAPS))


for _t in (DeltaNormTap(), EFResidualTap(), UpdateNormTap(), WeightTap(),
           ParticipationTap(), ControllerTap()):
    register_tap(_t)


@dataclass(frozen=True)
class Telemetry:
    """The taps active for one round-fn build, pre-filtered by kind and
    input availability; what the round factories consume."""

    taps: Tuple[TelemetryTap, ...]
    round_ctx: RoundTapCtx = field(default_factory=RoundTapCtx)

    def client_sums(self, ctx: ClientTapCtx) -> Dict[str, torch.Tensor]:
        """Flat namespaced sums for one client."""
        out: Dict[str, torch.Tensor] = {}
        for tap in self.taps:
            for k, v in tap.client_sums(ctx).items():
                out[f"{tap.name}.{k}"] = _f32(v)
        return out

    @staticmethod
    def sum_clients(per_client: List[Dict[str, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
        """The clients' ``client_sums`` dicts -> one dict of their sums."""
        if not per_client:
            return {}
        return {k: torch.stack([d[k] for d in per_client]).sum(0)
                for k in per_client[0]}

    def finish(self, summed: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Summed tap values -> emitted ``tele/`` metrics."""
        out: Dict[str, Any] = {}
        for tap in self.taps:
            for k, v in tap.finish(summed, self.round_ctx).items():
                out[TELEMETRY_PREFIX + k] = v
        return out


def make_telemetry(kind: str, *, n_clients: int = 1, n_shards: int = 1,
                   available: FrozenSet[str] = frozenset(),
                   taps: Optional[Sequence[str]] = None
                   ) -> Optional[Telemetry]:
    """Build the :class:`Telemetry` for one round-fn flavour.

    ``kind`` is ``"plain"`` or ``"compressed"``; ``available`` names the
    optional :class:`ClientTapCtx` fields the round will populate beyond
    the always-present ones (the engine passes ``{"ef"}`` only for
    stateful uplinks).  ``taps=None`` takes every registered tap that
    fits; an explicit name list selects (and validates) a subset.  Returns
    None when nothing applies — callers treat that like telemetry off.
    """
    if kind not in ("plain", "compressed"):
        raise ValueError(f"telemetry kind {kind!r} must be 'plain' or "
                         "'compressed'")
    base = {"n_examples", "loss"}
    base |= ({"model", "global_model"} if kind == "plain"
             else {"delta", "decoded", "global_model"})
    have = base | set(available)
    if taps is None:
        names = registered_taps()
    else:
        unknown = set(taps) - set(_TAPS)
        if unknown:
            raise KeyError(f"unknown telemetry taps {sorted(unknown)}; "
                           f"registered: {registered_taps()}")
        names = tuple(taps)
    chosen = tuple(
        _TAPS[n] for n in names
        if kind in _TAPS[n].kinds and set(_TAPS[n].requires) <= have)
    if not chosen:
        return None
    return Telemetry(taps=chosen,
                     round_ctx=RoundTapCtx(n_clients=n_clients,
                                           n_shards=n_shards))
