"""The ``Algorithm`` plugin interface + registry (port of
``repro/fl/api/algorithm.py``).

An :class:`Algorithm` supplies the hooks the federated machinery calls:

    init_extra_state    global-state entries beyond "model"
                        (FedFusion's fusion module params)
    local_loss          the client's two-stream training objective
    aggregate_extras /  server-side aggregation of the extra state
    finalize_extra_sums (the *_sums variant closes the client_sequential
                        running-sum path)
    deploy_logits       eval-time logits of the deployed global model

Plugins are stateless singletons registered by name; everything
configurable arrives through the :class:`FLConfig` each hook receives.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = ["Algorithm", "register_algorithm", "make_algorithm",
           "registered_algorithms"]


class Algorithm:
    """Base algorithm: FedAvg semantics; override hooks to add mechanisms.

    ``name``         registry key (``FLConfig.algorithm``).
    ``two_stream``   True when ``local_loss`` consumes the frozen global
                     stream's features (the local trainer then offers the
                     paper-§3.3 per-round feature cache).
    ``extra_state``  global-state keys carried beyond ``"model"``.
    """

    name: str = ""
    two_stream: bool = False
    extra_state: Tuple[str, ...] = ()

    def init_extra_state(self, bundle, fl, generator) -> Dict[str, Any]:
        """``{key: params}`` (on the CPU) for ``extra_state``."""
        return {}

    def extra_from_state(self, global_state) -> Any:
        """The extra-state value handed to the local trainer: the raw
        params for a single extra key, a dict for several, None for none."""
        if not self.extra_state:
            return None
        if len(self.extra_state) == 1:
            return global_state.get(self.extra_state[0])
        return {k: global_state[k] for k in self.extra_state}

    def init_trainable(self, fl, global_model, extra) -> Dict[str, Any]:
        """The client's trainable tree: ``"model"`` plus exactly
        ``extra_state``."""
        return {"model": global_model}

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        """``(loss, aux_dict)`` for one local step.  ``global_model`` is
        the FROZEN global stream; ``cached_feats_g`` its precomputed
        features when the trainer cached them (else None)."""
        raise NotImplementedError(self.name)

    def aggregate_extras(self, fl, global_state, stacked, weights,
                         shard=None) -> Dict[str, Any]:
        """Aggregate the clients' extra state (client_parallel path):
        ``stacked`` holds each extra with a leading client axis and
        ``weights`` are normalized over the whole round.  Under ``shard``
        (:class:`repro_torch.core.aggregate.ClientSharding`) the client
        axis holds only this rank's clients: complete any cross-client
        statistic with the ``repro_torch.core.aggregate`` all-reduce
        helpers.

        The engine's fused-collective path (the sharded default) does not
        call this hook: it packs the weighted sums of the stacked extras
        into the round's single all-reduce and closes them with
        :meth:`finalize_extra_sums`, so the two must agree:
        ``aggregate_extras(stacked, w) ==
        finalize_extra_sums(psum(tensordot(w, stacked)))`` (true of every
        in-tree plugin; one needing another cross-client statistic runs
        with ``fused_collective=False``)."""
        return {}

    def finalize_extra_sums(self, fl, global_state, sums) -> Dict[str, Any]:
        """Close the client_sequential running-sum path (and the fused
        collective's): ``sums`` holds the weighted sums of the clients'
        extra state, completed over the round."""
        return {}

    def deploy_logits(self, bundle, fl, global_state, out):
        """Logits of the deployed global model given ``out =
        bundle.apply(global_state['model'], batch)``."""
        return out["logits"]


_REGISTRY: Dict[str, Algorithm] = {}


def _ensure_builtins() -> None:
    import repro_torch.fl.api.plugins  # noqa: F401 — registers the four
    import repro_torch.contrib.fedprox  # noqa: F401 — out-of-core FedProx


def register_algorithm(algo: Algorithm, *, override: bool = False) -> Algorithm:
    """Register ``algo`` under ``algo.name``; re-registering a name needs
    ``override=True``."""
    if not algo.name:
        raise ValueError("Algorithm.name must be a non-empty string")
    if algo.name in _REGISTRY and not override:
        raise ValueError(f"algorithm {algo.name!r} already registered "
                         f"(pass override=True to replace)")
    _REGISTRY[algo.name] = algo
    return algo


def make_algorithm(name: str) -> Algorithm:
    """Look up an algorithm plugin by config name."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; choose from "
                         f"{registered_algorithms()}") from None


def registered_algorithms() -> Tuple[str, ...]:
    """All registered names, in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY)
