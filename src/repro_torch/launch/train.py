"""Federated LM training launcher on one device (port of
``repro/launch/train.py``'s round loop, without its mesh).

Usage (on the card; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --algorithm fedfusion --rounds 10 --scale tiny

Each round is one ``launch.steps.build_train_step`` round on batches
drawn, as the JAX loop draws them, with ``np.random.default_rng(0)`` from
a ``source_partition`` of ``token_stream``, at ``exp_decay_per_round(lr,
0.995)``.  The flags are the JAX launcher's; two differ:
``--device`` (default: the card) and ``--attn-impl`` (default ``pallas``,
so that attention runs K8a forward and K8b / K8c backward; the JAX
launcher trains with the config's ``jnp`` attention).  The engine does
not run LM bundles yet: ``--engine`` raises ``NotImplementedError``, and
the flags that only the engine reads (``--uplink-codec``,
``--participation``, ``--chaos``, ...) are not accepted.  Weights are
random, drawn on the device from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.configs.base import (ALGORITHM_NAMES, ArchConfig, FLConfig,
                                      InputShape)
from repro_torch.core.rounds import init_global_state
from repro_torch.data.partition import source_partition
from repro_torch.data.synth import token_stream
from repro_torch.device import resolve_device
from repro_torch.launch.specs import fl_plan
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import make_bundle
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_map


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_rounds(cfg: ArchConfig, fl: FLConfig, shape: InputShape, *,
                 rounds: int, device=None, global_state=None,
                 log: Optional[Callable[[str], None]] = print
                 ) -> Tuple[Dict, List[Dict]]:
    """The launcher's round loop on ``device`` (None: the card).

    ``global_state``: the initial state (e.g. converted from the JAX
    package); None draws one from seed 0 on the device.  Each round is
    timed on the host clock between device synchronisations.  Returns
    (final state, one ``{"round", "loss", "ms"}`` record per round)."""
    device = resolve_device(device)
    round_fn, _ = build_train_step(cfg, fl, shape)
    plan = fl_plan(cfg, shape)
    if global_state is None:
        global_state = init_global_state(
            make_bundle(cfg), fl,
            torch.Generator(device=device).manual_seed(0), device)
    state = tree_map(lambda t: t.to(device), global_state)

    toks, src = token_stream(
        max(plan.n_clients * plan.client_batch * 4, 64), shape.seq_len,
        vocab=cfg.vocab_size, n_sources=plan.n_clients)
    parts = source_partition(toks, src, plan.n_clients)
    rng = np.random.default_rng(0)
    lr_at = exp_decay_per_round(fl.lr, 0.995)
    nex = torch.ones((plan.n_clients,), dtype=torch.float32, device=device)

    def make_batch():
        per = []
        for c in range(plan.n_clients):
            pool = parts[c]["tokens"]
            idx = rng.choice(len(pool), (plan.local_steps, plan.client_batch))
            per.append(pool[idx])
        arr = torch.from_numpy(np.stack(per)).long()   # [C, steps, B, S+1]
        return {"tokens": arr[..., :-1].to(device),
                "labels": arr[..., 1:].to(device)}

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
    return state, records


def main(argv=None) -> None:
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
                    help="the client-parallel engine: not ported for LM "
                         "bundles yet (raises)")
    args = ap.parse_args(argv)

    if args.engine:
        raise NotImplementedError(
            "--engine: the engine (CUDA-graph supersteps) does not run LM "
            "bundles yet (ROADMAP Queue 1, slice 6: the engine for LM "
            "bundles); drop --engine to train through the round loop")
    device = resolve_device(args.device)
    cfg = ARCH_CONFIGS[args.arch]
    if args.scale == "tiny":
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=256)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    fl = FLConfig(algorithm=args.algorithm, fusion_op=args.fusion_op,
                  local_steps=2, lr=args.lr)
    shape = InputShape("custom_train", args.seq_len, args.global_batch,
                       "train")
    print(f"device {device} arch={cfg.name} ({cfg.param_count() / 1e6:.1f}M "
          f"params) attn_impl={cfg.attn_impl} algorithm={fl.algorithm}")
    train_rounds(cfg, fl, shape, rounds=args.rounds, device=device)
    print("done")


if __name__ == "__main__":
    main()
