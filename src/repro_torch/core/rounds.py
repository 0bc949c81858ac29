"""One federated round (port of ``repro/core/rounds.py``: ``make_round_fn``
without sharding, telemetry or participation, and ``init_global_state``).

* ``client_parallel`` trains every client of the round from the same
  global state, stacks their trainables on a leading client axis and
  aggregates with ``tensordot`` against the normalized weights, then hands
  the stacked extras to the plugin's ``aggregate_extras``.
* ``client_sequential`` keeps a running weighted sum of the clients'
  trainables and closes the extras with ``finalize_extra_sums``.

Both loop over the round's clients in Python; a batched client axis is
later work.  ``global_state`` is ``{'model': params, **extras}``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import FL_MODES, FLConfig
from repro_torch.core.aggregate import (mean_over_clients, normalize_weights,
                                        running_update, weighted_mean,
                                        zeros_like_tree)
from repro_torch.core.local import _algorithm, make_local_trainer
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelBundle
from repro_torch.tree import tree_map


def make_round_fn(bundle: ModelBundle, fl: FLConfig, mode: str):
    """Returns round_fn(global_state, client_batches, n_examples, lr) ->
    (new_global_state, {"local_loss": 0-d tensor}).

    ``client_batches``: dict of tensors [n_clients, local_steps, B, ...] on
    the global state's device; ``n_examples``: [n_clients] (n_t weights).
    """
    if mode not in FL_MODES:
        raise ValueError(f"unknown fl mode {mode!r}")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    trainer = make_local_trainer(bundle, fl)

    def round_fn(global_state, client_batches, n_examples, lr):
        weights = normalize_weights(n_examples)
        gm = global_state["model"]
        gx = algo.extra_from_state(global_state)
        n_clients = weights.shape[0]

        def client(c):
            return trainer(gm, gx, {k: v[c] for k, v in
                                    client_batches.items()}, lr)

        losses = []
        if mode == "client_parallel":
            trainables = []
            for c in range(n_clients):
                trainable, loss = client(c)
                trainables.append(trainable)
                losses.append(loss)
            stacked = tree_map(lambda *xs: torch.stack(xs), *trainables)
            new_state: Dict[str, Any] = {
                "model": weighted_mean(stacked["model"], weights)}
            new_state.update(algo.aggregate_extras(
                fl, global_state, {k: stacked[k] for k in extra_keys},
                weights))
        else:
            acc = {"model": zeros_like_tree(gm)}
            for k in extra_keys:
                acc[k] = zeros_like_tree(global_state[k])
            for c in range(n_clients):
                trainable, loss = client(c)
                acc = {k: running_update(acc[k], trainable[k], weights[c])
                       for k in acc}
                losses.append(loss)
            new_state = {"model": acc["model"]}
            new_state.update(algo.finalize_extra_sums(
                fl, global_state, {k: acc[k] for k in extra_keys}))
        return new_state, {"local_loss":
                           mean_over_clients(torch.stack(losses))}

    return round_fn


def init_global_state(bundle: ModelBundle, fl: FLConfig,
                      generator: torch.Generator, device=None):
    """Server line 1: the global model (+ the algorithm's extra state),
    drawn on the CPU from ``generator`` and moved to ``device`` (the card
    unless another device is named)."""
    device = resolve_device(device)
    algo = _algorithm(fl)
    state: Dict[str, Any] = {"model": bundle.init(generator)}
    state.update(algo.init_extra_state(bundle, fl, generator))
    return tree_map(lambda t: t.to(device), state)
