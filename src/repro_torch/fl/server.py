"""Federated server loop (port of ``repro/fl/server.py``; paper Alg. 1 /
Alg. 2).

``run_federated`` is the flat-keyword wrapper over
:class:`repro_torch.fl.api.FederatedTrainer`, which drives the engine
(``repro_torch.engine``: K-round chunks, captured as CUDA graphs on the
card).  ``run_federated_reference`` is the one-Python-dispatched-round-at-
a-time loop, kept as the engine's equivalence oracle and as the baseline
its rounds/s are measured against.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.convert import load_ef, restore
from repro_torch.checkpoint.io import save_server_state, save_tree
from repro_torch.compress import make_codec
from repro_torch.configs.base import FLConfig
from repro_torch.core.rounds import (init_global_state,
                                     make_compressed_round_fn, make_round_fn)
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.engine.engine import ServerResult
from repro_torch.engine.evaljit import make_eval_fn, pad_eval_batch
from repro_torch.fl.comm import CommLog
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ServerResult", "evaluate", "make_noise_source", "run_federated",
           "run_federated_reference"]

# the codec salt of the JAX loop's key derivation ("comp")
_NOISE_SALT = 0x636f6d70


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
    offsets)``, drawn with ``torch.rand`` on ``device`` from a generator
    seeded by ``(seed, r)``, so a round's offsets depend on its index
    only (as JAX's ``fold_in(key, r)``) and a resumed run draws what an
    uninterrupted one would.  Each round draws the downlink's leaves
    first, then the clients in positional order, leaf by leaf; a codec
    without noise draws nothing and gets None."""
    gen = torch.Generator(device=device)

    def draw(codec):
        return [torch.rand(n, generator=gen, device=device)
                for n in codec.noise_sizes()]

    def noise_fn(r, n_clients):
        gen.manual_seed((seed * 0x9E3779B1 + _NOISE_SALT * 0x85EBCA77 + r)
                        % (1 << 63))
        down = draw(downlink) if downlink.uses_noise else None
        up = ([draw(uplink) for _ in range(n_clients)]
              if uplink.uses_noise else None)
        return down, up

    return noise_fn


def run_federated(bundle: ModelBundle, fl: FLConfig, data: FederatedDataset,
                  *, rounds: int, seed: int = 0,
                  mode: str = "client_parallel", eval_every: int = 1,
                  eval_examples: int = 2048, verbose: bool = False,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 10,
                  checkpoint_from_jax: bool = False,
                  callback: Optional[Callable] = None,
                  superstep_rounds=8, prefetch: bool = True,
                  ef_store: str = "auto",
                  mesh=None, fused_collective: bool = True,
                  sharded_eval: bool = True, telemetry=False, runlog=None,
                  halt_on_nonfinite: bool = False,
                  profile_dir: Optional[str] = None, global_state=None,
                  noise_fn: Optional[Callable] = None,
                  device=None) -> ServerResult:
    """Flat-keyword wrapper over :class:`repro_torch.fl.api.FederatedTrainer`
    (the engine): the keywords map onto ``RunOptions``; ``global_state``
    and ``noise_fn`` go to ``fit``.  On the card every chunk runs as a
    CUDA graph replay; results equal :func:`run_federated_reference` on
    the same seed and configuration.  ``mesh`` (with ``fused_collective``
    and ``sharded_eval``) runs the client-sharded engine on every rank of
    the mesh (``repro_torch.launch.mesh.make_engine_mesh``)."""
    from repro_torch.fl.api import (CheckpointOptions, EngineOptions,
                                    EvalOptions, FederatedTrainer,
                                    RunOptions)
    opts = RunOptions(
        mode=mode, seed=seed, verbose=verbose, device=device,
        eval=EvalOptions(every=eval_every, examples=eval_examples),
        checkpoint=CheckpointOptions(dir=checkpoint_dir,
                                     every=checkpoint_every,
                                     from_jax=checkpoint_from_jax),
        engine=EngineOptions(superstep_rounds=superstep_rounds,
                             prefetch=prefetch, ef_store=ef_store, mesh=mesh,
                             fused_collective=fused_collective,
                             sharded_eval=sharded_eval,
                             telemetry=telemetry, runlog=runlog,
                             halt_on_nonfinite=halt_on_nonfinite,
                             profile_dir=profile_dir))
    return FederatedTrainer(bundle, fl, data, opts).fit(
        rounds, callback=callback, global_state=global_state,
        noise_fn=noise_fn)


def run_federated_reference(bundle: ModelBundle, fl: FLConfig,
                            data: FederatedDataset, *, rounds: int,
                            seed: int = 0, mode: str = "client_parallel",
                            eval_every: int = 1, eval_examples: int = 2048,
                            verbose: bool = False,
                            checkpoint_dir: Optional[str] = None,
                            checkpoint_every: int = 10,
                            checkpoint_from_jax: bool = False,
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

    ``checkpoint_dir``: every ``checkpoint_every`` rounds and at the end,
    the state goes to ``state.npz`` + ``meta.json`` (and, compressed, the
    EF table and the mirror to ``ef.npz``); a directory that holds a
    checkpoint resumes from it, replaying the sampling stream, so the
    resumed run equals the uninterrupted one.  ``checkpoint_from_jax``:
    the directory holds a checkpoint the JAX package wrote, converted on
    resume (:mod:`repro_torch.checkpoint.convert`).

    Partial participation, chaos and adaptive controllers are engine
    features: they raise ``NotImplementedError`` here, as in the JAX
    package.
    """
    device = resolve_device(device)
    if getattr(data, "chaos", None) is not None \
            or fl.participation != "full_sync":
        raise NotImplementedError(
            "partial participation / chaos injection is an engine feature "
            "(repro_torch.engine); the reference loop has no fault schedule "
            "and would silently diverge from the engine's rng stream")
    if fl.controller != "static":
        raise NotImplementedError(
            "adaptive compression controllers are an engine feature; the "
            "reference loop only runs the static codec configuration")
    if global_state is None:
        global_state = init_global_state(
            bundle, fl, torch.Generator().manual_seed(seed), device)
    else:
        global_state = tree_map(lambda t: torch.as_tensor(t).to(device),
                                global_state)
    start_round = 0
    from_jax = False
    if checkpoint_dir and os.path.exists(
            os.path.join(checkpoint_dir, "meta.json")):
        global_state, start_round, from_jax = restore(
            checkpoint_dir, global_state, device,
            from_jax=checkpoint_from_jax)
        # same stream replay as the engine: resumed == uninterrupted
        data.skip_round_sampling(start_round, fl.clients_per_round,
                                 fl.local_steps, fl.local_batch)
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
        ef_path = (os.path.join(checkpoint_dir, "ef.npz")
                   if checkpoint_dir else None)
        if start_round and ef_path and os.path.exists(ef_path):
            like = [None if z is None else
                    torch.empty((data.n_clients,) + tuple(z.shape),
                                device="meta") for z in uplink.init_state()]
            ef_disk, down_mirror = load_ef(ef_path, like, down_mirror,
                                           device, jax=from_jax)
            if ef_all is not None:
                ef_all = list(ef_disk)
        if noise_fn is None:
            noise_fn = make_noise_source(uplink, downlink, seed, device)
    else:
        round_fn = make_round_fn(bundle, fl, mode)

    def save(round_idx):
        save_server_state(checkpoint_dir, global_state, round_idx,
                          extra={"algorithm": fl.algorithm})
        if compressed:
            save_tree(ef_path, (ef_all if ef_all is not None
                                else uplink.init_state(), down_mirror))

    for r in range(start_round, rounds):
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
        if checkpoint_dir and (r + 1) % checkpoint_every == 0:
            save(r + 1)
    if checkpoint_dir:
        save(rounds)
    return ServerResult(global_state=global_state, comm=comm)
