"""Federated LM training launcher (port of ``repro/launch/train.py``).

Usage (on the card; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --algorithm fedfusion --rounds 10 --scale tiny
    PYTHONPATH=src python -m repro_torch.launch.train --engine \\
        --uplink-codec topk --controller ef_ratio --telemetry

Without ``--engine`` each round is one ``launch.steps.build_train_step``
round on batches drawn, as the JAX loop draws them, with
``np.random.default_rng(0)`` from a ``source_partition`` of
``token_stream``, at ``exp_decay_per_round(lr, 0.995)``.  A process that is
one rank of several (``torchrun --nproc-per-node=N``) runs the round on
:func:`mesh_from_devices`'s mesh, the JAX launcher's rule: the model
split over ``model``, the round's clients over ``data`` (a
``client_sequential`` model's leaves over ``data`` instead: the FSDP
round, ``launch.steps``); each rank draws the whole round's batch and
state from the same seeds and cuts its block
(``launch.sharding.shard_tree``), and only rank 0 prints.  A lone process
keeps the one-device round.  With
``--engine`` (:func:`run_engine`) the same model trains through
:class:`repro_torch.fl.api.FederatedTrainer` on a federated token dataset
(each chunk a CUDA graph replay on the card), with the engine-only flags
(``--ef-store``, ``--telemetry``, ``--runlog``, ``--profile``,
``--participation`` and its knobs, ``--chaos*``,
``--halt-on-nonfinite``, ``--uplink-codec``, ``--topk-frac``,
``--controller``, ``--ladder``), which the round loop ignores, as the JAX
launcher's does.  The flags are the JAX launcher's, with its names,
defaults and rules; two differ: ``--device`` (default: the card) and
``--attn-impl`` (default ``pallas``, so that attention runs K8a forward
and K8b / K8c backward; the JAX launcher trains with the config's
``jnp`` attention).  Weights are random, drawn on the device from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.configs.base import (ALGORITHM_NAMES, ArchConfig, FLConfig,
                                      InputShape)
from repro_torch.core.rounds import init_global_state
from repro_torch.data.federated import ChaosConfig, FederatedDataset
from repro_torch.data.partition import source_partition
from repro_torch.data.synth import token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import fl_plan
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import make_bundle
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_map


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_shape_for(n: int) -> Tuple[Tuple[int, int], Tuple[str, str]]:
    """The JAX launcher's mesh for ``n`` devices: ``model`` the largest of
    16, 8, 4, 2, 1 that divides ``n``, the rest ``data``."""
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0 and m <= n)
    return (n // model, model), ("data", "model")


def _world_size() -> int:
    import torch.distributed as dist
    return (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", "1")))


def mesh_from_devices(device=None):
    """:func:`mesh_shape_for` over every rank of the process group (made
    from ``torchrun``'s environment if there is none yet), on ``device``'s
    backend (NCCL on the card, gloo for ``"cpu"``)."""
    from repro_torch.launch.mesh import _ensure_process_group, make_mesh
    _ensure_process_group(resolve_device(device).type)
    shape, axes = mesh_shape_for(_world_size())
    return make_mesh(shape, axes, device=device)


def round_batches(cfg: ArchConfig, shape: InputShape, plan):
    """The launcher's data: a function that draws one round's whole batch,
    ``{"tokens", "labels"}`` int64 [n_clients, local_steps, client_batch,
    seq_len] on the CPU, from the seeded token stream split over
    ``plan.n_clients`` sources (the same draws on every rank).  The VLM
    and the encoder-decoder add their stub inputs (``vision_embeds`` /
    ``audio_frames`` [n_clients, local_steps, client_batch, n, d_model]
    float32, standard normal from a numpy generator of their own, seed 1:
    the token draws stay those of every other family).  The JAX launcher
    draws tokens only, so its round fails on these two families."""
    toks, src = token_stream(
        max(plan.n_clients * plan.client_batch * 4, 64), shape.seq_len,
        vocab=cfg.vocab_size, n_sources=plan.n_clients)
    parts = source_partition(toks, src, plan.n_clients)
    rng = np.random.default_rng(0)
    stub_rng = np.random.default_rng(1)
    lead = (plan.n_clients, plan.local_steps, plan.client_batch)
    stubs = {}
    if cfg.family == "vlm":
        stubs["vision_embeds"] = cfg.n_vision_tokens
    if cfg.family == "audio":
        stubs["audio_frames"] = cfg.n_audio_frames

    def draw():
        per = []
        for c in range(plan.n_clients):
            pool = parts[c]["tokens"]
            idx = rng.choice(len(pool), (plan.local_steps, plan.client_batch))
            per.append(pool[idx])
        arr = torch.from_numpy(np.stack(per)).long()   # [C, steps, B, S+1]
        batch = {"tokens": arr[..., :-1], "labels": arr[..., 1:]}
        for name, n in stubs.items():
            batch[name] = torch.from_numpy(stub_rng.standard_normal(
                lead + (n, cfg.d_model)).astype(np.float32))
        return batch

    return draw


def round_lr(fl: FLConfig):
    """The launcher's learning rate of round r (from 0)."""
    return exp_decay_per_round(fl.lr, 0.995)


def train_rounds(cfg: ArchConfig, fl: FLConfig, shape: InputShape, *,
                 rounds: int, device=None, global_state=None,
                 log: Optional[Callable[[str], None]] = print,
                 mesh=None) -> Tuple[Dict, List[Dict]]:
    """The launcher's round loop on ``device`` (None: the card).

    ``global_state``: the initial state (e.g. converted from the JAX
    package); None draws one from seed 0 on the device.  ``mesh``: run
    each round on this rank's blocks (``build_train_step(..., mesh)``;
    the FSDP round for a ``client_sequential`` model with ``data`` > 1),
    keeping only them once cut; every rank passes the same whole
    ``global_state`` (or none).  Each round is timed on the host clock
    between device synchronisations.
    Returns (final state, whole on every rank; one ``{"round", "loss",
    "ms"}`` record per round)."""
    device = resolve_device(device)
    round_fn, _, layouts, _ = build_train_step(cfg, fl, shape, mesh)
    plan = fl_plan(cfg, shape, mesh)
    if global_state is None:
        global_state = init_global_state(
            make_bundle(cfg), fl,
            torch.Generator(device=device).manual_seed(0), device)

    def cut(tree, specs):
        """Copies of this rank's blocks of ``tree`` (one device: all), so
        the whole can be freed."""
        if mesh is None:
            return tree
        return tree_map(lambda t: t.clone(memory_format=torch
                                          .contiguous_format),
                        sh.shard_tree(tree, specs, mesh))

    state = cut(tree_map(lambda t: t.to(device), global_state),
                layouts and layouts[0])
    del global_state       # a rank keeps only its blocks (the caller's own)

    draw = round_batches(cfg, shape, plan)
    lr_at = round_lr(fl)
    nex = cut(torch.ones((plan.n_clients,), dtype=torch.float32,
                         device=device), layouts and layouts[2])

    def make_batch():
        batch = cut(draw(), layouts and layouts[1])
        return {k: v.to(device) for k, v in batch.items()}

    records = []
    for r in range(rounds):
        batch = make_batch()
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = round_fn(state, batch, nex, lr_at(r))
        loss = float(metrics["local_loss"])
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        records.append({"round": r + 1, "loss": loss, "ms": ms})
        if log is not None:
            log(f"round {r + 1:3d}  loss={loss:.4f}  {ms:.0f} ms")
    if mesh is not None:
        state = sh.gather_tree(state, layouts[0], mesh)
    return state, records


def _engine_mesh(device):
    """``(mesh, client shards)``: ``make_engine_mesh()`` when this process
    is one rank of several (an initialised process group, or ``torchrun``'s
    ``WORLD_SIZE``), else ``(None, 1)``: a lone process is one shard, and
    needs no process group."""
    if _world_size() <= 1:
        return None, 1
    from repro_torch.launch.mesh import client_position, make_engine_mesh
    mesh = make_engine_mesh(device=device)
    return mesh, int(np.prod(client_position(mesh)[1]))


def engine_setup(args, cfg: ArchConfig, fl: FLConfig) -> Dict:
    """The engine run ``--engine`` makes: ``{"bundle", "fl", "data",
    "options", "mesh", "shards", "n_clients"}``, the JAX launcher's
    federation (``run_engine`` there).  The cohort is rounded down to a
    multiple of the client shards (the over-provisioned one up), the
    federation holds ``2 * max(clients_per_round, cohort)`` clients, each
    a source of ``token_stream``, the test set is 64 sequences of seed 1,
    eval runs every ``max(rounds // 2, 1)`` rounds on 64 examples, and
    the chunk size is calibrated (``superstep_rounds="auto"``).  A
    controller other than ``static`` makes ``topk`` the default uplink."""
    from repro_torch.fl.api import EngineOptions, EvalOptions, RunOptions
    from repro_torch.fl.participation import make_policy
    mesh, shards = _engine_mesh(args.device)
    ladder = (tuple(float(v) for v in args.ladder.split(","))
              if args.ladder else ())
    if args.controller != "static" and args.uplink_codec == "identity":
        # adaptive compression needs something to adapt: the top-k +
        # error-feedback codec at the paper's keep fraction
        args.uplink_codec = "topk"
    fl = dataclasses.replace(
        fl, clients_per_round=max(fl.clients_per_round, shards)
        // shards * shards,
        participation=args.participation,
        over_provision=args.over_provision,
        buffer_k=args.buffer_k,
        staleness_alpha=args.staleness_alpha,
        uplink_codec=args.uplink_codec,
        topk_frac=args.topk_frac,
        controller=args.controller,
        ladder=ladder)
    c_round = make_policy(fl.participation).cohort_size(
        fl.clients_per_round, fl)
    c_round = -(-c_round // shards) * shards
    n_clients = 2 * max(fl.clients_per_round, c_round)
    chaos = None
    if args.chaos:
        chaos = ChaosConfig(speed_sigma=args.chaos_speed_sigma,
                            jitter=args.chaos_jitter,
                            dropout=args.chaos_dropout,
                            truncation=args.chaos_truncation)
    toks, src = token_stream(
        max(n_clients * fl.local_batch * 8, 128), args.seq_len,
        vocab=cfg.vocab_size, n_sources=n_clients)
    test_toks, _ = token_stream(64, args.seq_len, vocab=cfg.vocab_size,
                                n_sources=n_clients, seed=1)
    data = FederatedDataset(source_partition(toks, src, n_clients),
                            {"tokens": test_toks}, seed=0, chaos=chaos)
    options = RunOptions(
        seed=0, verbose=True, device=args.device,
        eval=EvalOptions(every=max(args.rounds // 2, 1), examples=64),
        engine=EngineOptions(superstep_rounds="auto", mesh=mesh,
                             ef_store=args.ef_store,
                             telemetry=args.telemetry, runlog=args.runlog,
                             halt_on_nonfinite=args.halt_on_nonfinite,
                             profile_dir=args.profile))
    return {"bundle": make_bundle(cfg), "fl": fl, "data": data,
            "options": options, "mesh": mesh, "shards": shards,
            "n_clients": n_clients}


def run_engine(args, cfg: ArchConfig, fl: FLConfig):
    """Drive the launcher's workload through the engine
    (:func:`engine_setup`'s run of
    :class:`repro_torch.fl.api.FederatedTrainer`): on one device the
    single-device engine, under ``torchrun`` the client-sharded one.
    Returns the ``ServerResult``."""
    from repro_torch.fl.api import FederatedTrainer
    run = engine_setup(args, cfg, fl)
    fl, data, chaos = run["fl"], run["data"], run["data"].chaos
    mesh = run["mesh"]
    print(f"engine mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else {}} "
          f"clients/round={fl.clients_per_round} "
          f"federation={run['n_clients']}"
          + (f" participation={fl.participation}"
             if fl.participation != "full_sync" else "")
          + (" chaos=on" if chaos is not None else "")
          + (f" controller={fl.controller} uplink={fl.uplink_codec}"
             if fl.controller != "static" else ""))
    trainer = FederatedTrainer(run["bundle"], fl, data, run["options"])
    t0 = time.perf_counter()
    res = trainer.fit(args.rounds)
    dt = time.perf_counter() - t0
    st = res.stats
    print(f"done: {args.rounds} rounds in {dt:.1f}s "
          f"({args.rounds / dt:.2f} r/s)  device={st['device']} "
          f"chunk_rounds={st['chunk_rounds']} chunks={st['chunks']} "
          f"graphs={[g['rounds'] for g in st['graphs']]} "
          f"ef_store={st['ef_store']} "
          f"steady_rounds_per_s={st['steady_rounds_per_s']}")
    if args.telemetry and res.comm.history:
        last = res.comm.history[-1]
        tele = {k: v for k, v in last.items() if k.startswith("tele/")}
        if tele:
            print("telemetry (last round): " +
                  " ".join(f"{k}={v:.4g}" for k, v in sorted(tele.items())))
    return res


def main(argv=None):
    """Parse ``argv`` (None: the command line) and train; with
    ``--engine`` returns the engine's ``ServerResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--algorithm", default="fedavg",
                    choices=sorted(ALGORITHM_NAMES))
    ap.add_argument("--fusion-op", default="conv")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--attn-impl", default="pallas", choices=("pallas", "jnp"),
                    help="pallas: K8a / K8b / K8c; jnp: plain attention")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--engine", action="store_true",
                    help="run via the client-parallel engine "
                         "(repro_torch.engine: CUDA-graph supersteps on "
                         "the card) instead of the round loop")
    ap.add_argument("--ef-store", default="auto",
                    choices=("auto", "device", "host"),
                    help="engine only: EF residual backing — dense device "
                         "table, cohort-paged host store, or size-based "
                         "auto (paged runs are bitwise-equal)")
    ap.add_argument("--telemetry", action="store_true",
                    help="engine only: enable repro_torch.obs on-device "
                         "telemetry taps (tele/... metrics; "
                         "bitwise-invisible)")
    ap.add_argument("--runlog", default=None, metavar="PATH",
                    help="engine only: stream host span traces / events to "
                         "this JSONL file (repro_torch.obs.RunLog)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="engine only: write a torch.profiler trace for "
                         "the whole run into DIR")
    ap.add_argument("--participation", default="full_sync",
                    help="engine only: round participation policy "
                         "(full_sync | deadline | buffered_async | any "
                         "registered name)")
    ap.add_argument("--over-provision", type=float, default=1.5,
                    help="deadline policy: cohort over-sampling factor")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="buffered_async policy: close the round at the "
                         "K-th arrival (0 -> clients_per_round // 2)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="buffered_async policy: staleness discount "
                         "exponent (1+s)^-alpha")
    ap.add_argument("--chaos", action="store_true",
                    help="engine only: inject deterministic client faults "
                         "(speed skew, dropouts, truncated local work)")
    ap.add_argument("--chaos-speed-sigma", type=float, default=1.0,
                    help="lognormal sigma of static per-client speeds")
    ap.add_argument("--chaos-jitter", type=float, default=0.1,
                    help="lognormal sigma of per-round completion jitter")
    ap.add_argument("--chaos-dropout", type=float, default=0.05,
                    help="per-round client dropout probability")
    ap.add_argument("--chaos-truncation", type=float, default=0.0,
                    help="probability a client truncates its local work")
    ap.add_argument("--halt-on-nonfinite", action="store_true",
                    help="engine only: checkpoint and stop cleanly at the "
                         "first chunk boundary after a non-finite metric")
    ap.add_argument("--uplink-codec", default="identity",
                    help="engine only: client->server delta codec "
                         "(identity | topk | topk_noef | quant | int8 | "
                         "int4 | mask | lowrank)")
    ap.add_argument("--topk-frac", type=float, default=0.05,
                    help="top-k family codecs: kept coordinate fraction "
                         "(also the adaptive ladder's capacity level)")
    ap.add_argument("--controller", default="static",
                    help="engine only: in-superstep adaptive compression "
                         "controller (static | ef_ratio | bytes_budget | "
                         "loss_trend | any registered name); non-static "
                         "defaults --uplink-codec to topk")
    ap.add_argument("--ladder", default="", metavar="V0,V1,...",
                    help="controller ladder: ascending effective levels "
                         "(topk fracs or quant bits) topping out at the "
                         "static codec parameter; empty -> default ladder")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCH_CONFIGS[args.arch]
    if args.scale == "tiny":
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=256)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    fl = FLConfig(algorithm=args.algorithm, fusion_op=args.fusion_op,
                  local_steps=2, lr=args.lr)
    if args.engine:
        print(f"device {device} arch={cfg.name} "
              f"({cfg.param_count() / 1e6:.1f}M params) "
              f"attn_impl={cfg.attn_impl} algorithm={fl.algorithm}")
        return run_engine(args, cfg, dataclasses.replace(
            fl, clients_per_round=4, local_batch=args.global_batch))
    shape = InputShape("custom_train", args.seq_len, args.global_batch,
                       "train")
    mesh = mesh_from_devices(device) if _world_size() > 1 else None
    lead = mesh is None or mesh.get_rank() == 0
    say = print if lead else None
    if lead:
        print(f"device {device} arch={cfg.name} "
              f"({cfg.param_count() / 1e6:.1f}M params) "
              f"attn_impl={cfg.attn_impl} algorithm={fl.algorithm}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))
    if mesh is not None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    train_rounds(cfg, fl, shape, rounds=args.rounds, device=device,
                 mesh=mesh, log=say)
    if lead:
        print("done")


if __name__ == "__main__":
    main()
