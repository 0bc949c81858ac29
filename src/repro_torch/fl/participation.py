"""Participation policies: who makes it into a round, and at what weight
(port of ``repro/fl/participation.py``).

The engine is synchronous at the tensor level (every round aggregates a
fixed-shape ``[C', ...]`` cohort), but *which* of those C' lanes actually
contribute, and with what weight, is decided per round on the host by a
:class:`ParticipationPolicy`.  A policy looks at the round's simulated
arrival times / dropouts (the chaos draws of
``FederatedDataset.chaos_round``; see ``repro_torch.data.federated``) and
returns a :class:`RoundParticipation`: a 0/1 contribution mask, a
per-client staleness (in units of the round's closing time), the
staleness weight applied to each contribution, and the simulated
wall-clock the round took.

Masked clients are zeroed *by weight* inside the existing weighted mean
(no shape changes), and their error-feedback residual is carried forward
untouched (``repro_torch.core.rounds`` guards the EF update with the
mask).  Staleness weights are folded into the example weights on the host
(``sizes * mask * weight * work``), so the normalized weighted mean
downstream is exactly the staleness-discounted FedBuff-style average.

Built-in policies (registered under ``register_policy`` /
``make_policy``, mirroring ``make_algorithm`` / ``make_codec``):

``full_sync``
    The default and the bitwise oracle: the round closes when the slowest
    surviving client reports.  With chaos off this is the exact
    pre-participation engine (the engine skips participation plumbing
    entirely: no new inputs, no new graph).

``deadline``
    Over-provision the cohort to C' = ceil(C * fl.over_provision) and
    close the round when the first C surviving clients arrive; the
    laggards' weight is zeroed and their EF state is untouched.

``buffered_async``
    FedBuff-style buffered aggregation, simulated statelessly per round:
    the round closes when K of C contributions land (K =
    ``fl.buffer_k`` or C//2); later arrivals still contribute but are
    staleness-discounted by ``(1 + s)^(-fl.staleness_alpha)`` where
    ``s`` is how many round-durations late they landed.  This is the
    standard weight-based simulation of an async buffer: contributions
    stay in their own round (static shapes) while carrying the staleness
    discount an async server would apply.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Policy protocol + registry


@dataclass(frozen=True)
class RoundParticipation:
    """Host-side outcome of one round's participation decision.

    ``mask``/``staleness``/``weight`` are float32 ``[cohort]`` arrays;
    ``round_time`` is the simulated wall-clock of the round (in units of
    a nominal client round: arrival time 1.0 == a median client with no
    jitter); ``n_arrived`` is ``int(mask.sum())``.
    """

    mask: np.ndarray
    staleness: np.ndarray
    weight: np.ndarray
    round_time: float
    n_arrived: int


class ParticipationPolicy:
    """Base class: subclass, set ``name``, implement ``select``."""

    name: str = ""

    def cohort_size(self, clients_per_round: int, fl) -> int:
        """How many clients to sample per round (>= clients_per_round)."""
        return clients_per_round

    def select(self, arrival: np.ndarray, dropped: np.ndarray, fl,
               n_target: int) -> RoundParticipation:
        """Decide the round from simulated arrivals.

        ``arrival``: float ``[cohort]`` simulated completion times (chaos
        draws; all-ones when chaos is off).  ``dropped``: bool
        ``[cohort]``.  ``n_target`` is the pre-over-provision C.
        """
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------
    @staticmethod
    def _surviving(arrival: np.ndarray, dropped: np.ndarray) -> np.ndarray:
        """Bool alive-mask; guarantees at least one survivor (the fastest
        client is un-dropped), so the round's weight total is never zero."""
        alive = ~np.asarray(dropped, bool)
        if not alive.any():
            alive = alive.copy()
            alive[int(np.argmin(arrival))] = True
        return alive


Factory = Callable[[], ParticipationPolicy]

_REGISTRY: Dict[str, Factory] = {}
_BUILTINS_REGISTERED = False


def register_policy(name: str, factory: Factory, *, overwrite: bool = False) -> None:
    """Register a participation-policy factory under ``name``."""
    _ensure_builtins()
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"participation policy {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def make_policy(name: str) -> ParticipationPolicy:
    """Instantiate a registered participation policy by name."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise ValueError(f"unknown participation policy {name!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def registered_policies() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-in policies


class FullSyncPolicy(ParticipationPolicy):
    """Wait for everyone who did not drop; no staleness, no discount."""

    name = "full_sync"

    def select(self, arrival, dropped, fl, n_target):
        arrival = np.asarray(arrival, np.float32)
        alive = self._surviving(arrival, dropped)
        mask = alive.astype(np.float32)
        zeros = np.zeros_like(mask)
        return RoundParticipation(
            mask=mask, staleness=zeros, weight=np.ones_like(mask),
            round_time=float(arrival[alive].max()),
            n_arrived=int(alive.sum()))


class DeadlinePolicy(ParticipationPolicy):
    """Over-provision to C' > C; close when the first C survivors arrive."""

    name = "deadline"

    def cohort_size(self, clients_per_round, fl):
        over = float(getattr(fl, "over_provision", 1.0))
        return max(clients_per_round,
                   int(np.ceil(clients_per_round * over)))

    def select(self, arrival, dropped, fl, n_target):
        arrival = np.asarray(arrival, np.float32)
        alive = self._surviving(arrival, dropped)
        k = min(int(n_target), int(alive.sum()))
        # stable argsort: with chaos off every arrival is 1.0 and the
        # first C positions win deterministically.
        order = np.argsort(arrival, kind="stable")
        chosen = np.zeros(arrival.shape[0], bool)
        taken = 0
        for i in order:
            if alive[i]:
                chosen[i] = True
                taken += 1
                if taken == k:
                    break
        mask = chosen.astype(np.float32)
        zeros = np.zeros_like(mask)
        return RoundParticipation(
            mask=mask, staleness=zeros, weight=np.ones_like(mask),
            round_time=float(arrival[chosen].max()),
            n_arrived=int(chosen.sum()))


class BufferedAsyncPolicy(ParticipationPolicy):
    """Close at the K-th arrival; discount laggards by staleness."""

    name = "buffered_async"

    def select(self, arrival, dropped, fl, n_target):
        arrival = np.asarray(arrival, np.float32)
        alive = self._surviving(arrival, dropped)
        buffer_k = int(getattr(fl, "buffer_k", 0)) or max(1, n_target // 2)
        k = min(buffer_k, int(alive.sum()))
        t_close = float(np.sort(arrival[alive])[k - 1])
        # how many round-durations past the close each contribution lands
        staleness = np.where(
            alive, np.maximum(arrival / max(t_close, 1e-9) - 1.0, 0.0),
            0.0).astype(np.float32)
        alpha = float(getattr(fl, "staleness_alpha", 0.5))
        weight = ((1.0 + staleness) ** (-alpha)).astype(np.float32)
        mask = alive.astype(np.float32)
        return RoundParticipation(
            mask=mask, staleness=staleness, weight=weight,
            round_time=t_close, n_arrived=int(alive.sum()))


def _ensure_builtins() -> None:
    global _BUILTINS_REGISTERED
    if _BUILTINS_REGISTERED:
        return
    _BUILTINS_REGISTERED = True
    _REGISTRY["full_sync"] = FullSyncPolicy
    _REGISTRY["deadline"] = DeadlinePolicy
    _REGISTRY["buffered_async"] = BufferedAsyncPolicy
