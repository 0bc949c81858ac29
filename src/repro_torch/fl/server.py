"""Federated server loop (port of ``repro/fl/server.py``: ``evaluate`` and
``run_federated_reference`` with and without wire codecs; paper Alg. 1 /
Alg. 2), one Python-dispatched round at a time."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.compress import make_codec
from repro_torch.configs.base import FLConfig
from repro_torch.core.rounds import (init_global_state,
                                     make_compressed_round_fn, make_round_fn)
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.engine.evaljit import make_eval_fn, pad_eval_batch
from repro_torch.fl.comm import CommLog
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ServerResult", "evaluate", "make_noise_source",
           "run_federated_reference"]


@dataclass
class ServerResult:
    global_state: Dict
    comm: CommLog


def evaluate(bundle: ModelBundle, fl: FLConfig, global_state, batch,
             max_examples: int = 2048) -> Dict[str, float]:
    """Test accuracy and loss of the *global* model (paper's y-axis) on
    the padded, masked test batch, on the global state's device.  For
    FedFusion the deployed model fuses its own features with itself
    through the aggregated fusion module."""
    device = tree_leaves(global_state)[0].device
    padded, mask = pad_eval_batch(batch, max_examples, device)
    out = make_eval_fn(bundle, fl)(global_state, padded, mask)
    return {k: float(v) for k, v in out.items()}


def make_noise_source(uplink, downlink, seed: int, device) -> Callable:
    """The default stochastic-rounding offsets of a compressed run:
    ``noise_fn(r, n_clients) -> (downlink offsets, per-client uplink
    offsets)``, drawn with ``torch.rand`` from one generator on ``device``
    seeded from ``seed``.  Each round draws the downlink's leaves first,
    then the clients in positional order, leaf by leaf; a codec without
    noise draws nothing and gets None."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(codec):
        return [torch.rand(n, generator=gen, device=device)
                for n in codec.noise_sizes()]

    def noise_fn(r, n_clients):
        down = draw(downlink) if downlink.uses_noise else None
        up = ([draw(uplink) for _ in range(n_clients)]
              if uplink.uses_noise else None)
        return down, up

    return noise_fn


def run_federated_reference(bundle: ModelBundle, fl: FLConfig,
                            data: FederatedDataset, *, rounds: int,
                            seed: int = 0, mode: str = "client_parallel",
                            eval_every: int = 1, eval_examples: int = 2048,
                            verbose: bool = False,
                            checkpoint_dir: Optional[str] = None,
                            callback: Optional[Callable] = None,
                            global_state=None,
                            noise_fn: Optional[Callable] = None,
                            device=None) -> ServerResult:
    """The one-round-at-a-time server loop on ``device`` (the card unless
    another device is named).

    ``global_state``: the initial state (e.g. a converted JAX state, see
    :mod:`repro_torch.interop`); None draws one from ``seed``.  Sampling
    follows ``data``'s numpy rng stream exactly as the JAX loop does.

    With wire codecs (``fl.uplink_codec`` / ``fl.downlink_codec``) the
    round runs :func:`make_compressed_round_fn`; the per-client uplink EF
    rows (``[n_clients, n]`` per leaf, on ``device``) and the clients'
    broadcast mirror persist across rounds.  ``noise_fn(r, n_clients)``
    supplies the quant codecs' offsets (default
    :func:`make_noise_source` from ``seed``).

    Partial participation, adaptive controllers, checkpoints and the
    sketch codecs are not ported yet and raise ``NotImplementedError``.
    """
    device = resolve_device(device)
    if fl.participation != "full_sync":
        raise NotImplementedError(
            "partial participation is an engine feature and is not ported")
    if fl.controller != "static":
        raise NotImplementedError(
            "adaptive compression controllers are not ported")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet")
    if global_state is None:
        global_state = init_global_state(
            bundle, fl, torch.Generator().manual_seed(seed), device)
    else:
        global_state = tree_map(lambda t: torch.as_tensor(t).to(device),
                                global_state)
    lr_at = exp_decay_per_round(fl.lr, fl.lr_decay)
    comm = CommLog()
    test = data.test_batch()

    compressed = fl.compressed
    wire_up = wire_down = n_down = None
    if compressed:
        uplink = make_codec(fl.uplink_codec, topk_frac=fl.topk_frac,
                            quant_bits=fl.quant_bits)
        downlink = make_codec(fl.downlink_codec, topk_frac=fl.topk_frac,
                              quant_bits=fl.quant_bits)
        uplink.bind(global_state["model"])
        downlink.bind(global_state["model"])
        wire_up, wire_down = uplink.wire_bytes(), downlink.wire_bytes()
        if fl.downlink_codec != "identity":
            n_down = data.n_clients
        round_fn = make_compressed_round_fn(bundle, fl, mode, uplink,
                                            downlink)
        ef_all = ([torch.zeros((data.n_clients,) + tuple(s.shape),
                               device=device)
                   for s in uplink.init_state()]
                  if uplink.stateful else None)
        down_mirror = global_state["model"]
        if noise_fn is None:
            noise_fn = make_noise_source(uplink, downlink, seed, device)
    else:
        round_fn = make_round_fn(bundle, fl, mode)

    for r in range(rounds):
        cids = data.sample_clients(fl.clients_per_round)
        batches, sizes = data.round_batch(cids, fl.local_steps,
                                          fl.local_batch)
        batches = {k: torch.from_numpy(v).to(device)
                   for k, v in batches.items()}
        n_examples = torch.from_numpy(sizes).to(device)
        if compressed:
            rows = torch.as_tensor(cids, device=device)
            ef_round = (None if ef_all is None
                        else [e[rows] for e in ef_all])
            global_state, metrics, new_ef, down_mirror = round_fn(
                global_state, batches, n_examples, lr_at(r), ef_round,
                down_mirror, noise_fn(r, len(cids)))
            if ef_all is not None:
                for e, new in zip(ef_all, new_ef):
                    e[rows] = new
        else:
            global_state, metrics = round_fn(global_state, batches,
                                             n_examples, lr_at(r))
        metrics = {k: float(v) for k, v in metrics.items()}
        if (r + 1) % eval_every == 0:
            metrics.update(evaluate(bundle, fl, global_state, test,
                                    eval_examples))
        comm.log_round(global_state, len(cids), metrics, wire_up=wire_up,
                       wire_down=wire_down, n_down=n_down)
        if verbose:
            print(f"round {r+1:4d} " +
                  " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if callback is not None:
            callback(r, global_state, metrics)
    return ServerResult(global_state=global_state, comm=comm)
