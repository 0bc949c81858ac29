"""Batch shapes of a training round on one device (port of
``repro/launch/specs.py``: ``FLPlan``, ``fl_plan`` and the train half of
``input_specs``, without a mesh)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape


@dataclass(frozen=True)
class FLPlan:
    """How one FL round maps onto the device for the train shape."""
    n_clients: int
    local_steps: int
    client_batch: int


def fl_plan(cfg: ArchConfig, shape: InputShape) -> FLPlan:
    """The JAX plan on a one-device mesh: ``client_parallel`` runs one
    client per data group (one), ``client_sequential`` visits 4; each
    client takes 2 local steps and the global batch splits over them."""
    if shape.kind != "train":
        raise ValueError(f"fl_plan needs a 'train' shape, got "
                         f"{shape.kind!r}")
    nc = 1 if cfg.fl_mode == "client_parallel" else 4
    nc = min(nc, shape.global_batch)
    return FLPlan(n_clients=nc, local_steps=2,
                  client_batch=max(shape.global_batch // nc, 1))


def input_specs(cfg: ArchConfig, shape: InputShape
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The round batch of a train shape: name -> (shape, dtype), tokens
    and labels [n_clients, local_steps, client_batch, seq_len]."""
    plan = fl_plan(cfg, shape)
    lead = (plan.n_clients, plan.local_steps, plan.client_batch)
    return {"tokens": (lead + (shape.seq_len,), torch.int64),
            "labels": (lead + (shape.seq_len,), torch.int64)}
