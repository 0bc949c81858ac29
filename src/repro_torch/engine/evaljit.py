"""Global-model evaluation on a fixed-shape, masked batch (port of
``repro/engine/evaljit.py``, unsharded).

The test batch is truncated to ``max_examples`` and zero-padded to a
power-of-two bucket with a per-example validity mask; the masked means
equal the unpadded metrics (pad rows carry zero weight, the divisor is
the true example count).  The port runs eagerly, so the padding only
keeps the eval shapes the JAX package's.

Sharded evaluation (``make_eval_fn(shard=)`` + ``pad_eval_batch(shard=)``)
splits the padded batch positionally over the client ranks: each rank
forwards ``bucket / S`` examples and reduces masked metric *sums*, one
all-reduce adds the numerators and the true example count, and the
quotient equals the replicated masked mean (pad rows weigh zero on every
rank).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregate import ClientSharding, fused_psum
from repro_torch.core.losses import (masked_accuracy, masked_accuracy_sum,
                                     masked_cross_entropy,
                                     masked_cross_entropy_sum)


def make_eval_fn(bundle, fl, shard: Optional[ClientSharding] = None):
    """``eval_metrics(global_state, batch, mask) -> {acc, loss}`` (0-d
    tensors).  Deployment-time logits come from the plugin's
    ``deploy_logits`` hook.  For an LM bundle the labels are [B, S] next
    tokens: next-token accuracy and CE over every position of the valid
    sequences.  With ``shard``, ``batch`` / ``mask`` are this rank's
    positional slice of the padded batch, the masked sums cross the ranks
    in one all-reduce, and every rank returns the same metrics."""
    from repro_torch.fl.api import make_algorithm
    algo = make_algorithm(fl.algorithm)

    @torch.no_grad()
    def eval_metrics(global_state, batch, mask) -> Dict:
        out = bundle.apply(global_state["model"], batch)
        logits = algo.deploy_logits(bundle, fl, global_state, out)
        labels = bundle.labels(batch)
        if shard is None:
            return {"acc": masked_accuracy(logits, labels, mask),
                    "loss": masked_cross_entropy(logits, labels, mask)}
        correct, w = masked_accuracy_sum(logits, labels, mask)
        ce, _ = masked_cross_entropy_sum(logits, labels, mask)
        sums = fused_psum({"correct": correct, "ce": ce, "w": w}, shard)
        denom = sums["w"].clamp_min(1.0)
        return {"acc": sums["correct"] / denom, "loss": sums["ce"] / denom}

    return eval_metrics


def pad_eval_batch(batch, max_examples: int = 2048, device="cpu",
                   shard=None) -> Tuple[Dict, torch.Tensor]:
    """Truncate to ``max_examples``, zero-pad to a power-of-two bucket
    (capped at ``max_examples``).  Returns (padded batch on ``device``,
    [bucket] bool mask).  Image batches count ``x``, token batches
    ``tokens``.  An empty batch raises ``ValueError``.  ``shard`` (a shard
    count or a :class:`ClientSharding`) rounds the bucket up to a multiple
    of the shard count, so the positional split divides; the extra rows
    are masked pad like any other."""
    key = "x" if "x" in batch else "tokens"
    n = min(len(batch[key]), max_examples)
    if n == 0:
        raise ValueError(
            "pad_eval_batch: the evaluation batch has 0 examples — masked "
            "metrics would be undefined; supply a non-empty test set")
    bucket = 1
    while bucket < n:
        bucket *= 2
    bucket = min(bucket, max_examples)
    if shard is not None:
        n_shards = getattr(shard, "n_shards", shard)
        bucket = -(-bucket // n_shards) * n_shards
    padded = {}
    for k, v in batch.items():
        v = np.asarray(v[:n])
        if bucket > n:
            v = np.pad(v, ((0, bucket - n),) + ((0, 0),) * (v.ndim - 1))
        padded[k] = torch.from_numpy(v).to(device)
    mask = torch.from_numpy(np.arange(bucket) < n).to(device)
    return padded, mask
