"""Uniform ModelBundle API over the paper's CNNs and the transformer LMs
(port of ``repro/models/registry.py``).

The FL core is written against this protocol:
    bundle.init(generator)           -> params (on the generator's device)
    bundle.extract(params, batch)    -> (features, aux)   # trunk only
    bundle.head(params, features)    -> logits
    bundle.apply(params, batch)      -> {'features','logits','aux'}
    bundle.pool(features)            -> [B, C] pooled features (for MMD)
    bundle.labels(batch)             -> targets for the loss
    bundle.loss_kind                 -> 'lm' | 'classify'
    bundle.feature_channels          -> fusion channel width C
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.configs.base import ArchConfig, CNNConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Union[ArchConfig, CNNConfig]
    init: Callable[..., Any]
    extract: Callable[..., Any]
    head: Callable[..., Any]
    apply: Callable[..., Dict[str, Any]]
    pool: Callable[..., Any]
    labels: Callable[[Dict[str, Any]], Any]
    loss_kind: str
    feature_channels: int


def make_bundle(cfg: Union[ArchConfig, CNNConfig], dtype=torch.float32
                ) -> ModelBundle:
    if isinstance(cfg, CNNConfig):
        return _cnn_bundle(cfg, dtype)
    if isinstance(cfg, ArchConfig):
        return _transformer_bundle(cfg, dtype)
    raise NotImplementedError(f"{type(cfg).__name__}: make_bundle builds "
                              "the CNNs (CNNConfig) and the transformer LMs "
                              "(ArchConfig) only")


def _cnn_bundle(cfg: CNNConfig, dtype) -> ModelBundle:
    def init(generator):
        return cnn_mod.cnn_init(cfg, generator, dtype)

    def extract(params, batch):
        return cnn_mod.cnn_extract(cfg, params, batch["x"]), 0.0

    def head(params, feats):
        return cnn_mod.cnn_head(cfg, params, feats)

    def apply(params, batch):
        return cnn_mod.cnn_apply(cfg, params, batch["x"])

    def pool(feats):           # [B,h,w,C] -> [B,C]
        return feats.mean(dim=(1, 2))

    return ModelBundle(
        name=cfg.name, config=cfg, init=init, extract=extract, head=head,
        apply=apply, pool=pool, labels=lambda b: b["y"],
        loss_kind="classify", feature_channels=cfg.conv_channels[-1])


def _transformer_bundle(cfg: ArchConfig, dtype) -> ModelBundle:
    def init(generator):
        return tfm.init_params(cfg, generator, dtype, generator.device)

    def extract(params, batch):
        out = tfm.forward_seq(cfg, params, batch, want_logits=False)
        return out["features"], out["aux"]

    def head(params, feats):
        return tfm.head_apply(cfg, params, feats)

    def apply(params, batch):
        return tfm.forward_seq(cfg, params, batch)

    def pool(feats):           # [B,S,d] -> [B,d]
        return feats.mean(dim=1)

    def labels(batch):
        # next-token prediction: labels[t] = tokens[t+1]; last target is pad
        if "labels" in batch:
            return batch["labels"]
        toks = batch["tokens"]
        return torch.cat([toks[:, 1:], toks[:, -1:]], dim=1)

    return ModelBundle(
        name=cfg.name, config=cfg, init=init, extract=extract, head=head,
        apply=apply, pool=pool, labels=labels, loss_kind="lm",
        feature_channels=cfg.d_model)


def decode_step(cfg: ArchConfig, params, tokens, cache, pos):
    return tfm.decode_step(cfg, params, tokens, cache, pos)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    return tfm.init_cache(cfg, batch, max_len, dtype, device)
