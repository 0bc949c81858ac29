"""The paper's four mechanisms as :class:`Algorithm` plugins (port of
``repro/fl/api/plugins.py``):

  fedavg    L = L_cls(theta_L)
  fedmmd    L = L_cls(theta_L) + lam * MMD^2(theta_G(X), theta_L(X))
  fedl2     L = L_cls(theta_L) + lam2 * ||Theta_L - Theta_G||^2
  fedfusion L = L_cls(C_L(F(E_l(X), E_g(X))))   with E_g frozen

The frozen global stream is NEVER updated during local training (paper
Fig. 1): its features are computed under ``torch.no_grad()`` and detached.
"""
from __future__ import annotations

import torch

from repro_torch.core.fusion import fusion_aggregate, fusion_apply, fusion_init
from repro_torch.core.losses import cross_entropy, l2_tree_distance
from repro_torch.core.mmd import mmd_loss
from repro_torch.fl.api.algorithm import Algorithm, register_algorithm
from repro_torch.parallel import (data_dim, gather_from_data, model_dim,
                                  reduce_from_model)
from repro_torch.tree import tree_map

AUX_WEIGHT = 0.01  # MoE load-balance loss weight (0 aux for the CNNs)

__all__ = ["AUX_WEIGHT", "classify_loss", "FedAvg", "FedMMD", "FedL2",
           "FedFusion"]


def _tp(bundle):
    """The bundle's tensor-parallel context (an LM split over ``model``),
    or None."""
    return getattr(bundle, "tp", None)


def _mp(bundle):
    """The bundle's ``model``-axis context (a tensor-parallel LM), or
    None."""
    return getattr(bundle, "mp", None)


def classify_loss(bundle, local, batch):
    """Plain single-stream forward: (cls_loss, labels, out)."""
    labels = bundle.labels(batch)
    out = bundle.apply(local, batch)
    cls = cross_entropy(out["logits"], labels, _mp(bundle)) \
        + AUX_WEIGHT * out["aux"]
    return cls, labels, out


def _frozen_features(bundle, global_model, batch, cached):
    """The frozen stream's features: the per-round cache when the trainer
    recorded one (paper §3.3), recomputed without grad otherwise."""
    if cached is None:
        with torch.no_grad():
            cached, _ = bundle.extract(global_model, batch)
    return cached.detach()


class FedAvg(Algorithm):
    name = "fedavg"

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        cls, _, _ = classify_loss(bundle, trainable["model"], batch)
        return cls, {"cls": cls}


class FedMMD(Algorithm):
    name = "fedmmd"
    two_stream = True

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        cls, _, out = classify_loss(bundle, trainable["model"], batch)
        feats_g = _frozen_features(bundle, global_model, batch,
                                   cached_feats_g)
        pooled = [bundle.pool(out["features"]), bundle.pool(feats_g)]
        tp = _tp(bundle)
        if tp is not None and tp.data_rows:
            # FSDP: the term compares the whole batch's pooled features
            # (a mean of per-rank MMDs is another loss); the gather's
            # backward sums the ranks' gradients and keeps this rank's rows
            pooled = [gather_from_data(f, 0, tp.mp) for f in pooled]
        reg = mmd_loss(*pooled, fl.mmd_widths, fl.mmd_lambda)
        return cls + reg, {"cls": cls, "mmd": reg}


def _l2_distance(bundle, local, global_model):
    """``l2_tree_distance``; on a tensor-parallel bundle the split leaves'
    part is summed over ``model`` (each rank holds its blocks).  Under
    FSDP it is this rank's estimate of the distance (``core/local.py``):
    the part of the leaves split over ``data`` times the data size, whose
    mean over the data ranks is their whole part."""
    tp = _tp(bundle)
    if tp is None or (not tp.active and tp.data_size == 1):
        return l2_tree_distance(local, global_model)
    whole, part = [], []

    def term(a, b, spec):
        d = l2_tree_distance([a], [b])
        if data_dim(spec) is not None:
            d = d * tp.data_size
        split = tp.active and model_dim(spec) is not None
        (part if split else whole).append(d)

    tree_map(term, local, global_model, tp.model_specs)
    return sum(whole) + reduce_from_model(torch.as_tensor(sum(part)), tp.mp)


class FedL2(Algorithm):
    name = "fedl2"

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        cls, _, _ = classify_loss(bundle, trainable["model"], batch)
        reg = fl.l2_lambda * _l2_distance(bundle, trainable["model"],
                                          global_model)
        return cls + reg, {"cls": cls, "l2": reg}


class FedFusion(Algorithm):
    name = "fedfusion"
    two_stream = True
    extra_state = ("fusion",)

    def init_extra_state(self, bundle, fl, generator):
        return {"fusion": fusion_init(fl.fusion_op, bundle.feature_channels,
                                      generator)}

    def init_trainable(self, fl, global_model, extra):
        return {"model": global_model, "fusion": extra}

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        labels = bundle.labels(batch)
        feats_l, aux = bundle.extract(trainable["model"], batch)
        feats_g = _frozen_features(bundle, global_model, batch,
                                   cached_feats_g)
        fused = fusion_apply(fl.fusion_op, trainable["fusion"],
                             feats_g, feats_l, _tp(bundle))
        logits = bundle.head(trainable["model"], fused)
        loss = cross_entropy(logits, labels, _mp(bundle)) + AUX_WEIGHT * aux
        return loss, {"cls": loss}

    def aggregate_extras(self, fl, global_state, stacked, weights,
                         shard=None):
        return {"fusion": fusion_aggregate(
            fl.fusion_op, global_state["fusion"], stacked["fusion"],
            weights, fl.ema_beta, shard=shard)}

    def finalize_extra_sums(self, fl, global_state, sums):
        # the running sums already carry the n_t weighting; conv weights
        # average like any parameter, multi/single gates EMA-smooth
        # against the previous global gate (paper §3.3)
        if fl.fusion_op == "conv":
            return {"fusion": sums["fusion"]}
        return {"fusion": tree_map(
            lambda old, new: fl.ema_beta * old + (1 - fl.ema_beta) * new,
            global_state["fusion"], sums["fusion"])}

    def deploy_logits(self, bundle, fl, global_state, out):
        # the deployed global model fuses its own features with itself
        # through the aggregated fusion module (E_g = E_l = global)
        fused = fusion_apply(fl.fusion_op, global_state["fusion"],
                             out["features"], out["features"], _tp(bundle))
        return bundle.head(global_state["model"], fused)


register_algorithm(FedAvg())
register_algorithm(FedMMD())
register_algorithm(FedL2())
register_algorithm(FedFusion())
