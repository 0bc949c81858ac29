"""Classification losses and the two-stream constraints (port of
``repro/core/losses.py``)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def _gold_and_logz(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return logz, gold


def cross_entropy(logits, labels):
    """logits [..., V]; labels [...] int -> scalar mean CE."""
    logz, gold = _gold_and_logz(logits, labels)
    return (logz - gold).mean()


def accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()


def _broadcast_mask(mask, labels):
    """Per-example mask [B] -> weights broadcast to the labels' shape."""
    mask = mask.float()
    return mask.reshape(mask.shape + (1,) * (labels.dim() - mask.dim())
                        ).expand(labels.shape)


def masked_cross_entropy_sum(logits, labels, mask):
    """Masked CE *sum* and weight sum: ``(Σ ce·w, Σ w)``."""
    logz, gold = _gold_and_logz(logits, labels)
    w = _broadcast_mask(mask, labels)
    return ((logz - gold) * w).sum(), w.sum()


def masked_accuracy_sum(logits, labels, mask):
    """Masked correct-prediction *sum* and weight sum."""
    correct = (logits.argmax(dim=-1) == labels).float()
    w = _broadcast_mask(mask, labels)
    return (correct * w).sum(), w.sum()


def masked_cross_entropy(logits, labels, mask):
    """Mean CE over the valid examples only (mask [B] bool/float)."""
    ce_sum, w_sum = masked_cross_entropy_sum(logits, labels, mask)
    return ce_sum / w_sum.clamp_min(1.0)


def masked_accuracy(logits, labels, mask):
    """Accuracy over the valid examples only (mask [B] bool/float)."""
    correct_sum, w_sum = masked_accuracy_sum(logits, labels, mask)
    return correct_sum / w_sum.clamp_min(1.0)


def l2_tree_distance(tree_a, tree_b):
    """Sum of squared parameter distances (the paper's L2 two-stream
    baseline constraint)."""
    return sum((a.float() - b.float()).square().sum()
               for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)))
