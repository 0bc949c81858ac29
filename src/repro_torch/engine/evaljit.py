"""Global-model evaluation on a fixed-shape, masked batch (port of
``repro/engine/evaljit.py``, unsharded).

The test batch is truncated to ``max_examples`` and zero-padded to a
power-of-two bucket with a per-example validity mask; the masked means
equal the unpadded metrics (pad rows carry zero weight, the divisor is
the true example count).  The port runs eagerly, so the padding only
keeps the eval shapes the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.losses import masked_accuracy, masked_cross_entropy


def make_eval_fn(bundle, fl):
    """``eval_metrics(global_state, batch, mask) -> {acc, loss}`` (0-d
    tensors).  Deployment-time logits come from the plugin's
    ``deploy_logits`` hook.  For an LM bundle the labels are [B, S] next
    tokens: next-token accuracy and CE over every position of the valid
    sequences."""
    from repro_torch.fl.api import make_algorithm
    algo = make_algorithm(fl.algorithm)

    @torch.no_grad()
    def eval_metrics(global_state, batch, mask) -> Dict:
        out = bundle.apply(global_state["model"], batch)
        logits = algo.deploy_logits(bundle, fl, global_state, out)
        labels = bundle.labels(batch)
        return {"acc": masked_accuracy(logits, labels, mask),
                "loss": masked_cross_entropy(logits, labels, mask)}

    return eval_metrics


def pad_eval_batch(batch, max_examples: int = 2048, device="cpu"
                   ) -> Tuple[Dict, torch.Tensor]:
    """Truncate to ``max_examples``, zero-pad to a power-of-two bucket
    (capped at ``max_examples``).  Returns (padded batch on ``device``,
    [bucket] bool mask).  Image batches count ``x``, token batches
    ``tokens``.  An empty batch raises ``ValueError``."""
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
    padded = {}
    for k, v in batch.items():
        v = np.asarray(v[:n])
        if bucket > n:
            v = np.pad(v, ((0, bucket - n),) + ((0, 0),) * (v.ndim - 1))
        padded[k] = torch.from_numpy(v).to(device)
    mask = torch.from_numpy(np.arange(bucket) < n).to(device)
    return padded, mask
