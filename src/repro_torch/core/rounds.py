"""One federated round (port of ``repro/core/rounds.py``: ``make_round_fn``,
``make_compressed_round_fn``, their deferred-all-reduce splits
``make_round_parts`` / ``make_compressed_round_parts``, and
``init_global_state``).

* ``client_parallel`` trains every client of the round from the same
  global state, stacks their trainables on a leading client axis and
  aggregates with ``tensordot`` against the normalized weights, then hands
  the stacked extras to the plugin's ``aggregate_extras``.
* ``client_sequential`` keeps a running weighted sum of the clients'
  trainables and closes the extras with ``finalize_extra_sums``.

Both loop over the round's clients in Python; a batched client axis is
later work.  ``global_state`` is ``{'model': params, **extras}``.

Sharding contract (``repro_torch.engine.sharded``): with ``shard``, a
:class:`repro_torch.core.aggregate.ClientSharding`, the round runs on one
rank of a client group.  Its client axis holds only this rank's slice of
the round's clients (rank s trains positions ``[s*C_loc, (s+1)*C_loc)``),
every per-client quantity (local training, codec encode and decode, EF
rows, stochastic-rounding offsets) stays on the rank, and the only
collectives are the all-reduces of ``repro_torch.core.aggregate`` and the
plugin's ``aggregate_extras``.  The replicated inputs (global model,
mirror, learning rate) give the same replicated outputs on every rank,
because every rank receives the same all-reduced sums.  With
``shard=None`` the round is the single-device one, op for op.

Fused-collective contract (``repro_torch.engine.superstep`` with
``fused=True``): the ``*_round_parts`` factories split a round into a
*local* function (everything up to this rank's weighted contribution
sums, no collective) and a *finish* function that reads the all-reduced
sums.  The superstep packs the local sums, the EF exchange and the next
round's weight total into ONE flat buffer and one all-reduce
(:func:`repro_torch.core.aggregate.fused_psum`).  The split keeps every
arithmetic op of the unfused round (the weights divide by a total
all-reduced one round ahead; extras close through ``finalize_extra_sums``,
whose ops equal the in-tree plugins' ``aggregate_extras`` after the
weighted sum), so fused and unfused rounds differ only in the order the
backend sums each element (bitwise equal at two ranks).

Participation contract (``repro_torch.fl.participation``): every round fn
takes two optional trailing ``[n_clients]`` float32 inputs, ``pmask`` (0/1
contribution mask) and ``pstale`` (staleness, read by the participation
telemetry tap only), the JAX package's ``participation=True`` round.
Masked clients are zeroed purely *by weight*: the engine multiplies the
staged sizes by ``mask * staleness_weight * work`` on the host, so the
normalized weighted mean excludes them with no shape change.  The round
adds two things: (a) a masked client's EF row is carried forward
untouched (its payload never reached the server, so its dropped mass must
stay local), and (b) the round loss is the mask-weighted mean (its
numerator and denominator ride the round's collective when sharded).
Without them (``pmask=None``, the default) the round is the one without
this axis, op for op.

Telemetry (``repro_torch.obs.telemetry``): with ``telemetry`` set, each
client fills a :class:`ClientTapCtx`, the taps' sums are added over the
clients (and all-reduced with the round's sums when sharded) and
``telemetry.finish`` adds the ``tele/...`` metrics.  The taps only read
tensors the round computes anyway, so the round's state and
``local_loss`` are bit-equal to a round without them; with
``telemetry=None`` the round is the one without taps, op for op.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import FL_MODES, FLConfig
from repro_torch.control.controller import take
from repro_torch.core.aggregate import (ClientSharding, finish_masked_loss,
                                        masked_loss, masked_loss_sums,
                                        mean_over_clients, normalize_weights,
                                        psum_tree, running_update,
                                        weighted_mean, zeros_like_tree)
from repro_torch.core.local import _algorithm, make_local_trainer
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelBundle
from repro_torch.obs.telemetry import ClientTapCtx
from repro_torch.tree import tree_map

_RESERVED_CONTRIB_KEYS = frozenset(("model", "delta", "loss", "lsum", "lw",
                                    "tele"))


def _check_extra_keys(extra_keys):
    """The fused contribution dicts key the model / delta sums and the
    loss beside the plugin's extras: an extra named after one of them
    would be overwritten, so refuse it when the round is built."""
    clash = _RESERVED_CONTRIB_KEYS.intersection(extra_keys)
    if clash:
        raise ValueError(
            f"Algorithm.extra_state keys {sorted(clash)} collide with the "
            f"round accumulators' reserved keys "
            f"{sorted(_RESERVED_CONTRIB_KEYS)}; rename the extra state "
            "entries")


def _round_loss(losses, pmask, shard=None):
    if shard is None:
        return (mean_over_clients(losses) if pmask is None
                else masked_loss(losses, pmask))
    if pmask is None:
        return mean_over_clients(losses, shard)
    return finish_masked_loss(psum_tree(masked_loss_sums(losses, pmask),
                                        shard))


def _loss_contribs(losses, pmask):
    """This rank's all-reduce-pending loss terms (fused path)."""
    if pmask is None:
        return {"loss": losses.mean()}
    return masked_loss_sums(losses, pmask)


def _finish_loss(summed, shard):
    if "lsum" in summed:
        return finish_masked_loss(summed)
    return summed["loss"] / shard.n_shards


def _part(pmask, pstale, c):
    """Client ``c``'s (pmask, staleness) for its tap context."""
    if pmask is None:
        return None, None
    return pmask[c], pstale[c]


def _shard_kw(shard):
    """``aggregate_extras``' shard keyword, passed only when sharded, so a
    plugin written against the one-device hook keeps working."""
    return {} if shard is None else {"shard": shard}


def _weighted_sums(stacked, weights):
    """tensordot(weights, leading-client-axis tree): the in-rank half of
    :func:`weighted_mean` (the all-reduce completes it)."""
    return tree_map(lambda x: torch.tensordot(weights.to(x.dtype), x, dims=1),
                    stacked)


def _make_plain_clients(bundle: ModelBundle, fl: FLConfig, mode: str, *,
                        telemetry=None):
    """The client side of one uncompressed round.

    Returns ``run_clients(global_state, client_batches, weights, lr,
    n_examples, pmask, pstale) -> (out, losses [C], tele)``: ``out`` is
    ``{"model": ..., **extras}`` stacked on a leading client axis
    (client_parallel) or the clients' weighted running sums
    (client_sequential); ``tele`` the taps' sums over this rank's clients
    (``{}`` without telemetry).
    """
    if mode not in FL_MODES:
        raise ValueError(f"unknown fl mode {mode!r}")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    trainer = make_local_trainer(bundle, fl)

    def run_clients(global_state, client_batches, weights, lr, n_examples,
                    pmask=None, pstale=None):
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
            out = {k: stacked[k] for k in ("model",) + tuple(extra_keys)}
        else:
            out = {"model": zeros_like_tree(gm)}
            for k in extra_keys:
                out[k] = zeros_like_tree(global_state[k])
            for c in range(n_clients):
                trainable, loss = client(c)
                out = {k: running_update(out[k], trainable[k], weights[c])
                       for k in out}
                losses.append(loss)
                del trainable     # before the next client trains
        tele = ({} if telemetry is None
                else telemetry.sum_clients(taps))
        return out, torch.stack(losses), tele

    return run_clients


def make_round_fn(bundle: ModelBundle, fl: FLConfig, mode: str, *,
                  shard: Optional[ClientSharding] = None, telemetry=None):
    """Returns round_fn(global_state, client_batches, n_examples, lr) ->
    (new_global_state, {"local_loss": 0-d tensor}).

    ``client_batches``: dict of tensors [n_clients, local_steps, B, ...] on
    the global state's device; ``n_examples``: [n_clients] (n_t weights).
    Under ``shard`` both carry this rank's clients only.
    ``pmask`` / ``pstale`` [n_clients] (module docstring): with them
    ``n_examples`` arrives already mask- and staleness-weighted from the
    host, and the round loss is the mask-weighted mean.  ``telemetry`` (a
    :class:`repro_torch.obs.telemetry.Telemetry`) adds its ``tele/...``
    metrics.
    """
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    run_clients = _make_plain_clients(bundle, fl, mode, telemetry=telemetry)

    def round_fn(global_state, client_batches, n_examples, lr, pmask=None,
                 pstale=None):
        weights = normalize_weights(n_examples, shard)
        out, losses, tele = run_clients(global_state, client_batches,
                                        weights, lr, n_examples, pmask,
                                        pstale)
        if mode == "client_parallel":
            new_state: Dict[str, Any] = {
                "model": weighted_mean(out["model"], weights, shard)}
            new_state.update(algo.aggregate_extras(
                fl, global_state, {k: out[k] for k in extra_keys}, weights,
                **_shard_kw(shard)))
        else:
            # the running sums covered this rank's clients; the
            # all-reduce completes them over the round (no-op unsharded)
            sums = psum_tree(out, shard)
            new_state = {"model": sums["model"]}
            new_state.update(algo.finalize_extra_sums(
                fl, global_state, {k: sums[k] for k in extra_keys}))
        metrics = {"local_loss": _round_loss(losses, pmask, shard)}
        if telemetry is not None:
            metrics.update(telemetry.finish(psum_tree(tele, shard)))
        return new_state, metrics

    return round_fn


def make_round_parts(bundle: ModelBundle, fl: FLConfig, mode: str, *,
                     shard: ClientSharding, telemetry=None):
    """Deferred-all-reduce split of :func:`make_round_fn` (the fused
    collective).  Returns ``(local_fn, finish_fn)``:

    ``local_fn(global_state, client_batches, total, n_examples, lr[,
    pmask, pstale]) -> contribs``: this rank's pending sums ``{"model":
    tree, **extras, "loss" (or "lsum" / "lw" with pmask), "tele": {...}}``.
    ``total`` is the round's all-reduced example count (the superstep
    pipelines it one collective ahead: the sizes are staged inputs);
    dividing by it is :func:`normalize_weights`, bit for bit.

    ``finish_fn(global_state, summed) -> (new_state, metrics)`` reads the
    all-reduced contributions; extras close through the plugin's
    ``finalize_extra_sums``.
    """
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    _check_extra_keys(extra_keys)
    run_clients = _make_plain_clients(bundle, fl, mode, telemetry=telemetry)

    def local_fn(global_state, client_batches, total, n_examples, lr,
                 pmask=None, pstale=None):
        weights = n_examples.float() / total
        out, losses, tele = run_clients(global_state, client_batches,
                                        weights, lr, n_examples, pmask,
                                        pstale)
        if mode == "client_parallel":
            out = {k: _weighted_sums(v, weights) for k, v in out.items()}
        return {**out, **_loss_contribs(losses, pmask), "tele": tele}

    def finish_fn(global_state, summed):
        new_state: Dict[str, Any] = {"model": summed["model"]}
        new_state.update(algo.finalize_extra_sums(
            fl, global_state, {k: summed[k] for k in extra_keys}))
        metrics = {"local_loss": _finish_loss(summed, shard)}
        if telemetry is not None:
            metrics.update(telemetry.finish(summed["tele"]))
        return new_state, metrics

    return local_fn, finish_fn


def _make_compressed_clients(bundle: ModelBundle, fl: FLConfig, mode: str,
                             uplink, downlink, *, telemetry=None,
                             controller=None):
    """The client side of one codec-routed round.

    Returns ``run_clients(global_state, client_batches, weights, lr,
    ef_state, down_mirror, noise, n_examples, pmask, pstale, level) ->
    (out, new_ef, losses [C], tele, bcast)``: ``out`` is ``{"delta":
    decoded, **extras}`` stacked (client_parallel) or the weighted running
    sums (client_sequential), ``new_ef`` this rank's clients' new EF rows
    (one [C, n] tensor per uplink leaf, or None), ``bcast`` the clients'
    next downlink mirror.
    """
    if mode not in FL_MODES:
        raise ValueError(f"unknown fl mode {mode!r}")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    trainer = make_local_trainer(bundle, fl)

    def run_clients(global_state, client_batches, weights, lr, ef_state,
                    down_mirror, noise, n_examples, pmask=None, pstale=None,
                    level=None):
        eff_bytes = (None if level is None
                     else take(controller.bytes_table(), level))
        down_noise, up_noise = noise
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
            out = tree_map(lambda *xs: torch.stack(xs), *outs)
        else:
            out = {"delta": zeros_like_tree(gm)}
            for k in extra_keys:
                out[k] = zeros_like_tree(global_state[k])
            for c in range(n_clients):
                o, new_ef, loss = client(c)
                out = {k: running_update(out[k], o[k], weights[c])
                       for k in out}
                efs.append(new_ef)
                losses.append(loss)
                del o             # before the next client trains
        new_ef = (None if ef_state is None else
                  [torch.stack(rows) for rows in zip(*efs)])
        tele = ({} if telemetry is None
                else telemetry.sum_clients(taps))
        return out, new_ef, torch.stack(losses), tele, bcast

    return run_clients


def _apply_delta(global_state, delta):
    """The aggregate update on the FULL-PRECISION server model."""
    return tree_map(lambda g, d: g + d.to(g.dtype), global_state["model"],
                    delta)


def make_compressed_round_fn(bundle: ModelBundle, fl: FLConfig, mode: str,
                             uplink, downlink, *,
                             shard: Optional[ClientSharding] = None,
                             telemetry=None, controller=None):
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
    tensors or None (the codec's deterministic variant).  Under ``shard``
    the client inputs, the EF rows and the uplink offsets are this rank's
    positional clients'; steps 1 and 3 run replicated.

    ``pmask`` / ``pstale`` [n_clients] (after ``noise``): a masked
    client's new EF row is its incoming row, bit for bit, and the round
    loss is the mask-weighted mean.

    ``telemetry`` adds its ``tele/...`` metrics (module docstring).
    Controller contract (``repro_torch.control``): with ``controller`` set
    the round fn takes a trailing ``ctrl_state`` dict of 0-d tensors and
    returns ``controller.update(ctrl_state, metrics)`` as a fifth output.
    The incoming ``ctrl_state["level"]`` (0-d int32) selects the ladder
    rung every client of THIS round encodes at; nothing reads it on the
    host.  The update reads the all-reduced metrics, so it adds no
    collective and gives the same state on every rank.  A controller
    needs telemetry for its signals.
    """
    if controller is not None and telemetry is None:
        raise ValueError("a controller needs telemetry for its decision "
                         "signals (the engine forces the required taps on)")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    run_clients = _make_compressed_clients(bundle, fl, mode, uplink,
                                           downlink, telemetry=telemetry,
                                           controller=controller)

    def round_fn(global_state, client_batches, n_examples, lr, ef_state,
                 down_mirror, noise=(None, None), pmask=None, pstale=None,
                 ctrl_state=None):
        if controller is not None and ctrl_state is None:
            raise ValueError("a controller round needs ctrl_state")
        level = None if controller is None else ctrl_state["level"]
        weights = normalize_weights(n_examples, shard)
        out, new_ef, losses, tele, bcast = run_clients(
            global_state, client_batches, weights, lr, ef_state,
            down_mirror, noise, n_examples, pmask, pstale, level)
        if mode == "client_parallel":
            delta = weighted_mean(out["delta"], weights, shard)
            extras = algo.aggregate_extras(
                fl, global_state, {k: out[k] for k in extra_keys}, weights,
                **_shard_kw(shard))
        else:
            sums = psum_tree(out, shard)
            delta = sums["delta"]
            extras = algo.finalize_extra_sums(
                fl, global_state, {k: sums[k] for k in extra_keys})
        new_state: Dict[str, Any] = {"model": _apply_delta(global_state,
                                                           delta)}
        new_state.update(extras)
        metrics = {"local_loss": _round_loss(losses, pmask, shard)}
        if telemetry is not None:
            metrics.update(telemetry.finish(psum_tree(tele, shard)))
        if controller is None:
            return new_state, metrics, new_ef, bcast
        return (new_state, metrics, new_ef, bcast,
                controller.update(ctrl_state, metrics))

    return round_fn


def make_compressed_round_parts(bundle: ModelBundle, fl: FLConfig,
                                mode: str, uplink, downlink, *,
                                shard: ClientSharding, telemetry=None,
                                controller=None):
    """Deferred-all-reduce split of :func:`make_compressed_round_fn` for
    the fused-collective superstep.  Returns ``(local_fn, finish_fn)``:

    ``local_fn(global_state, client_batches, total, n_examples, lr,
    ef_state, down_mirror, noise[, pmask, pstale], ctrl_state=None) ->
    (contribs, aux)``: ``contribs`` ``{"delta": tree, **extras, "loss" (or
    "lsum" / "lw"), "tele": {...}}`` are this rank's pending sums; ``aux``
    carries ``new_ef`` (this rank's clients' new EF rows, which the
    superstep routes through the fused exchange) and ``bcast`` (the next
    downlink mirror).  ``total`` is the round's all-reduced example
    count, pipelined one collective ahead.  With a controller,
    ``ctrl_state["level"]`` selects the round's encode rung.

    ``finish_fn(global_state, summed, ctrl_state=None) -> (new_state,
    metrics[, new_ctrl])`` applies the all-reduced delta to the
    full-precision model, closes extras through ``finalize_extra_sums``
    and, with a controller, runs its update on the all-reduced metrics:
    the split adds nothing to the fused all-reduce beyond the taps' sums.
    """
    if controller is not None and telemetry is None:
        raise ValueError("a controller needs telemetry for its decision "
                         "signals (the engine forces the required taps on)")
    algo = _algorithm(fl)
    extra_keys = algo.extra_state
    _check_extra_keys(extra_keys)
    run_clients = _make_compressed_clients(bundle, fl, mode, uplink,
                                           downlink, telemetry=telemetry,
                                           controller=controller)

    def local_fn(global_state, client_batches, total, n_examples, lr,
                 ef_state, down_mirror, noise, pmask=None, pstale=None,
                 ctrl_state=None):
        level = None if controller is None else ctrl_state["level"]
        weights = n_examples.float() / total
        out, new_ef, losses, tele, bcast = run_clients(
            global_state, client_batches, weights, lr, ef_state,
            down_mirror, noise, n_examples, pmask, pstale, level)
        if mode == "client_parallel":
            out = {k: _weighted_sums(v, weights) for k, v in out.items()}
        contribs = {**out, **_loss_contribs(losses, pmask), "tele": tele}
        return contribs, {"new_ef": new_ef, "bcast": bcast}

    def finish_fn(global_state, summed, ctrl_state=None):
        new_state: Dict[str, Any] = {"model": _apply_delta(global_state,
                                                           summed["delta"])}
        new_state.update(algo.finalize_extra_sums(
            fl, global_state, {k: summed[k] for k in extra_keys}))
        metrics = {"local_loss": _finish_loss(summed, shard)}
        if telemetry is not None:
            metrics.update(telemetry.finish(summed["tele"]))
        if controller is None:
            return new_state, metrics
        return new_state, metrics, controller.update(ctrl_state, metrics)

    return local_fn, finish_fn


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
