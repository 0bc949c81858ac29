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
    bundle.tp                        -> None, or the LM's
                                        parallel.TensorParallel: params
                                        are then this rank's blocks
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

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
    tp: Optional[Any] = None

    @property
    def mp(self):
        """The ``model``-axis context when the bundle is split, else None."""
        return self.tp.mp if self.tp is not None and self.tp.active \
            else None


def make_bundle(cfg: Union[ArchConfig, CNNConfig], dtype=torch.float32,
                tp=None) -> ModelBundle:
    """The bundle of ``cfg``.  ``tp`` (a
    :class:`repro_torch.parallel.TensorParallel`, LMs only): the bundle
    runs on this rank's parameter blocks, its logits split on V where the
    head is; ``init`` still draws the whole model (the caller cuts it)."""
    if isinstance(cfg, CNNConfig):
        if tp is not None:
            raise NotImplementedError("the CNNs are not tensor-parallel")
        return _cnn_bundle(cfg, dtype)
    if isinstance(cfg, ArchConfig):
        return _transformer_bundle(cfg, dtype, tp)
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


def _transformer_bundle(cfg: ArchConfig, dtype, tp=None) -> ModelBundle:
    def init(generator):
        return tfm.init_params(cfg, generator, dtype, generator.device)

    def extract(params, batch):
        # the batch may carry the VLM's / encoder-decoder's stub inputs
        # beside tokens and labels; the features are the decoder's [B,S,d]
        out = tfm.forward_seq(cfg, params, batch, want_logits=False, tp=tp)
        return out["features"], out["aux"]

    def head(params, feats):
        # under tp, ``feats`` must be ready for a head split on V (their
        # gradient summed over ``model`` where they were made):
        # ``tfm.head_input``'s, or FedFusion's ``fusion_apply``'s
        return tfm.head_apply(cfg, params, feats, tp)

    def apply(params, batch):
        return tfm.forward_seq(cfg, params, batch, tp=tp)

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
        feature_channels=cfg.d_model, tp=tp)


def decode_step(cfg: ArchConfig, params, tokens, cache, pos):
    return tfm.decode_step(cfg, params, tokens, cache, pos)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    return tfm.init_cache(cfg, batch, max_len, dtype, device)
