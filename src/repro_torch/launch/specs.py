"""Shapes of every model input (port of ``repro/launch/specs.py``): how a
training round maps onto a mesh (``FLPlan``, ``fl_plan``), the batch of
a train, prefill or decode shape (``input_specs``), and the assignment's
carve-outs (``skip_reason``).  A shape here is ``(shape tuple, dtype)``:
nothing is allocated."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape

Struct = Tuple[Tuple[int, ...], torch.dtype]


@dataclass(frozen=True)
class FLPlan:
    """How one FL round maps onto the mesh for the train shape."""
    n_clients: int
    local_steps: int
    client_batch: int


def fl_plan(cfg: ArchConfig, shape: InputShape, mesh=None) -> FLPlan:
    """``client_parallel`` runs one client per data(-pod) group,
    ``axis_size(mesh, "pod", "data")`` clients (one on one device, ``mesh``
    None); ``client_sequential`` visits 4.  Each client takes 2 local
    steps and the global batch splits over the clients."""
    if shape.kind != "train":
        raise ValueError(f"fl_plan needs a 'train' shape, got "
                         f"{shape.kind!r}")
    if cfg.fl_mode == "client_parallel":
        from repro_torch.launch.mesh import axis_size
        nc = 1 if mesh is None else axis_size(mesh, "pod", "data")
    else:
        nc = 4
    nc = min(nc, shape.global_batch)
    return FLPlan(n_clients=nc, local_steps=2,
                  client_batch=max(shape.global_batch // nc, 1))


def input_specs(cfg: ArchConfig, shape: InputShape, mesh=None,
                dtype=torch.float32) -> Dict[str, Struct]:
    """The batch of ``shape``, name -> (shape, dtype).  Train: tokens and
    labels [n_clients, local_steps, client_batch, seq_len]; prefill:
    tokens [B, S]; decode: one new token [B, 1] (the cache is built by
    ``launch.steps``).  VLM and audio inputs add their stub embeddings
    (``vision_embeds`` / ``audio_frames``)."""
    S = shape.seq_len
    if shape.kind == "train":
        plan = fl_plan(cfg, shape, mesh)
        lead = (plan.n_clients, plan.local_steps, plan.client_batch)
        batch = {"tokens": (lead + (S,), torch.int64),
                 "labels": (lead + (S,), torch.int64)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = (
                lead + (cfg.n_vision_tokens, cfg.d_model), dtype)
        if cfg.family == "audio":
            batch["audio_frames"] = (
                lead + (cfg.n_audio_frames, cfg.d_model), dtype)
        return batch
    B = shape.global_batch
    if shape.kind == "prefill":
        batch = {"tokens": ((B, S), torch.int64)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = (
                (B, cfg.n_vision_tokens, cfg.d_model), dtype)
        if cfg.family == "audio":
            batch["audio_frames"] = (
                (B, cfg.n_audio_frames, cfg.d_model), dtype)
        return batch
    return {"tokens": ((B, 1), torch.int64)}


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """The assignment's carve-outs (DESIGN.md section 6)."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return "enc-dec audio backbone: context bounded by encoder frames"
        if not cfg.has_subquadratic_decode:
            return "pure full-attention arch: no sub-quadratic variant"
    return None
