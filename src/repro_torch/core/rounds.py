"""One federated round (port of ``repro/core/rounds.py``: ``make_round_fn``
and ``make_compressed_round_fn`` without sharding, and
``init_global_state``).

* ``client_parallel`` trains every client of the round from the same
  global state, stacks their trainables on a leading client axis and
  aggregates with ``tensordot`` against the normalized weights, then hands
  the stacked extras to the plugin's ``aggregate_extras``.
* ``client_sequential`` keeps a running weighted sum of the clients'
  trainables and closes the extras with ``finalize_extra_sums``.

Both loop over the round's clients in Python; a batched client axis is
later work.  ``global_state`` is ``{'model': params, **extras}``.

Participation contract (``repro_torch.fl.participation``): both
factories' round fns take two optional trailing ``[n_clients]`` float32
inputs, ``pmask`` (0/1 contribution mask) and ``pstale`` (staleness, read
by the participation telemetry tap only), the JAX package's
``participation=True`` round.
Masked clients are zeroed purely *by weight*: the engine multiplies the
staged sizes by ``mask * staleness_weight * work`` on the host, so the
normalized weighted mean excludes them with no shape change.  The round
adds two things: (a) a masked client's EF row is carried forward
untouched (its payload never reached the server, so its dropped mass must
stay local), and (b) the round loss is the mask-weighted mean
(:func:`masked_loss`).  Without them (``pmask=None``, the default) the
round is the one without this axis, op for op.

Telemetry (``repro_torch.obs.telemetry``): with ``telemetry`` set, each
client fills a :class:`ClientTapCtx`, the taps' sums are added over the
clients and ``telemetry.finish`` adds the ``tele/...`` metrics.  The taps
only read tensors the round computes anyway, so the round's state and
``local_loss`` are bit-equal to a round without them; with
``telemetry=None`` the round is the one without taps, op for op.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import FL_MODES, FLConfig
from repro_torch.control.controller import take
from repro_torch.core.aggregate import (masked_loss, mean_over_clients,
                                        normalize_weights, running_update,
                                        weighted_mean, zeros_like_tree)
from repro_torch.core.local import _algorithm, make_local_trainer
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelBundle
from repro_torch.obs.telemetry import ClientTapCtx
from repro_torch.tree import tree_map


def _round_loss(losses, pmask):
    losses = torch.stack(losses)
    return (mean_over_clients(losses) if pmask is None
            else masked_loss(losses, pmask))


def _part(pmask, pstale, c):
    """Client ``c``'s (pmask, staleness) for its tap context."""
    if pmask is None:
        return None, None
    return pmask[c], pstale[c]


def make_round_fn(bundle: ModelBundle, fl: FLConfig, mode: str, *,
                  telemetry=None):
    """Returns round_fn(global_state, client_batches, n_examples, lr) ->
    (new_global_state, {"local_loss": 0-d tensor}).

    ``client_batches``: dict of tensors [n_clients, local_steps, B, ...] on
    the global state's device; ``n_examples``: [n_clients] (n_t weights).
    ``pmask`` / ``pstale`` [n_clients] (module docstring): with them
    ``n_examples`` arrives already mask- and staleness-weighted from the
    host, and the round loss is the mask-weighted mean.  ``telemetry`` (a
    :class:`repro_torch.obs.telemetry.Telemetry`) adds its ``tele/...``
    metrics.
    """
    if mode not in FL_MODES:
        raise ValueError(f"unknown fl mode {mode!r}")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    trainer = make_local_trainer(bundle, fl)

    def round_fn(global_state, client_batches, n_examples, lr, pmask=None,
                 pstale=None):
        weights = normalize_weights(n_examples)
        gm = global_state["model"]
        gx = algo.extra_from_state(global_state)
        n_clients = weights.shape[0]

        taps = []

        def client(c):
            trainable, loss = trainer(gm, gx, {k: v[c] for k, v in
                                               client_batches.items()}, lr)
            if telemetry is not None:
                m, st = _part(pmask, pstale, c)
                taps.append(telemetry.client_sums(ClientTapCtx(
                    n_examples=n_examples[c], loss=loss,
                    model=trainable["model"], global_model=gm, pmask=m,
                    staleness=st)))
            return trainable, loss

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
        metrics = {"local_loss": _round_loss(losses, pmask)}
        if telemetry is not None:
            metrics.update(telemetry.finish(telemetry.sum_clients(taps)))
        return new_state, metrics

    return round_fn


def make_compressed_round_fn(bundle: ModelBundle, fl: FLConfig, mode: str,
                             uplink, downlink, *, telemetry=None,
                             controller=None):
    """A federated round with the wire path routed through codecs.

    Returns round_fn(global_state, client_batches, n_examples, lr,
    ef_state, down_mirror, noise=(None, None)) -> (new_global_state,
    metrics, new_ef_state, new_down_mirror):

      1. downlink: the server encodes the model *update* against the
         mirror of what clients hold, ``downlink.encode(model - mirror)``,
         statelessly (the mirror gap already carries every dropped unit of
         mass), and every client trains from ``bcast = mirror +
         decode(payload)``, which becomes the next mirror;
      2. each client encodes its delta against ``bcast`` with its EF row
         and the server decodes it;
      3. the server applies ``sum_i w_i * decoded_i`` to its FULL-PRECISION
         model, so downlink codec error never accumulates in it.

    The algorithm's extra state (FedFusion's fusion module) rides
    uncompressed.  ``ef_state``: per uplink leaf a [n_clients, n] tensor
    of the round's EF rows, or None for a stateless uplink.  ``noise``:
    (downlink offsets, per-client uplink offsets), each a list of per-leaf
    tensors or None (the codec's deterministic variant).

    ``pmask`` / ``pstale`` [n_clients] (after ``noise``): a masked
    client's new EF row is its incoming row, bit for bit, and the round
    loss is the mask-weighted mean.

    ``telemetry`` adds its ``tele/...`` metrics (module docstring).
    Controller contract (``repro_torch.control``): with ``controller`` set
    the round fn takes a trailing ``ctrl_state`` dict of 0-d tensors and
    returns ``controller.update(ctrl_state, metrics)`` as a fifth output.
    The incoming ``ctrl_state["level"]`` (0-d int32) selects the ladder
    rung every client of THIS round encodes at; nothing reads it on the
    host.  A controller needs telemetry for its signals.
    """
    if mode not in FL_MODES:
        raise ValueError(f"unknown fl mode {mode!r}")
    if controller is not None and telemetry is None:
        raise ValueError("a controller needs telemetry for its decision "
                         "signals (the engine forces the required taps on)")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    trainer = make_local_trainer(bundle, fl)

    def round_fn(global_state, client_batches, n_examples, lr, ef_state,
                 down_mirror, noise=(None, None), pmask=None, pstale=None,
                 ctrl_state=None):
        if controller is not None and ctrl_state is None:
            raise ValueError("a controller round needs ctrl_state")
        level = None if controller is None else ctrl_state["level"]
        eff_bytes = (None if level is None
                     else take(controller.bytes_table(), level))
        down_noise, up_noise = noise
        weights = normalize_weights(n_examples)
        n_clients = weights.shape[0]
        gm = global_state["model"]
        down_payload, _ = downlink.encode(
            tree_map(lambda m, w: m - w, gm, down_mirror), None, down_noise)
        bcast = tree_map(lambda w, d: w + d.to(w.dtype), down_mirror,
                         downlink.decode(down_payload))
        gx = algo.extra_from_state(global_state)
        taps = []

        def client(c):
            trainable, loss = trainer(bcast, gx, {k: v[c] for k, v in
                                                  client_batches.items()}, lr)
            delta = tree_map(lambda a, b: a - b, trainable["model"], bcast)
            ef = None if ef_state is None else [e[c] for e in ef_state]
            payload, new_ef = uplink.encode(
                delta, ef, None if up_noise is None else up_noise[c],
                level=level)
            if pmask is not None and ef is not None:
                # dropped / late client: its payload never uplinked, so
                # the residual it would have cleared stays local intact
                new_ef = [n if n is None else torch.where(pmask[c] > 0, n, o)
                          for n, o in zip(new_ef, ef)]
            decoded = uplink.decode(payload)
            if telemetry is not None:
                m, st = _part(pmask, pstale, c)
                taps.append(telemetry.client_sums(ClientTapCtx(
                    n_examples=n_examples[c], loss=loss, global_model=bcast,
                    delta=delta, decoded=decoded, ef=new_ef, pmask=m,
                    staleness=st, level=level, eff_bytes=eff_bytes)))
            out = {"delta": decoded}
            out.update({k: trainable[k] for k in extra_keys})
            return out, new_ef, loss

        losses, efs = [], []
        if mode == "client_parallel":
            outs = []
            for c in range(n_clients):
                out, new_ef, loss = client(c)
                outs.append(out)
                efs.append(new_ef)
                losses.append(loss)
            stacked = tree_map(lambda *xs: torch.stack(xs), *outs)
            delta = weighted_mean(stacked["delta"], weights)
            extras = algo.aggregate_extras(
                fl, global_state, {k: stacked[k] for k in extra_keys},
                weights)
        else:
            acc = {"delta": zeros_like_tree(gm)}
            for k in extra_keys:
                acc[k] = zeros_like_tree(global_state[k])
            for c in range(n_clients):
                out, new_ef, loss = client(c)
                acc = {k: running_update(acc[k], out[k], weights[c])
                       for k in acc}
                efs.append(new_ef)
                losses.append(loss)
            delta = acc["delta"]
            extras = algo.finalize_extra_sums(
                fl, global_state, {k: acc[k] for k in extra_keys})
        new_state: Dict[str, Any] = {
            "model": tree_map(lambda g, d: g + d.to(g.dtype), gm, delta)}
        new_state.update(extras)
        new_ef = (None if ef_state is None else
                  [torch.stack(rows) for rows in zip(*efs)])
        metrics = {"local_loss": _round_loss(losses, pmask)}
        if telemetry is not None:
            metrics.update(telemetry.finish(telemetry.sum_clients(taps)))
        if controller is None:
            return new_state, metrics, new_ef, bcast
        return (new_state, metrics, new_ef, bcast,
                controller.update(ctrl_state, metrics))

    return round_fn


def init_global_state(bundle: ModelBundle, fl: FLConfig,
                      generator: torch.Generator, device=None):
    """Server line 1: the global model (+ the algorithm's extra state),
    drawn from ``generator`` on its own device (a CUDA generator draws on
    the card) and placed on ``device`` (the card unless another device is
    named)."""
    device = resolve_device(device)
    algo = _algorithm(fl)
    state: Dict[str, Any] = {"model": bundle.init(generator)}
    state.update(algo.init_extra_state(bundle, fl, generator))
    return tree_map(lambda t: t.to(device), state)
