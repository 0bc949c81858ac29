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


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE of logits split on V over ``model``: the max, the sum
    of exponentials and the target logit are all-reduced; the gradient of
    this rank's block is its softmax less the one-hot of the targets it
    owns, so the backward makes no collective."""

    @staticmethod
    def forward(ctx, logits, labels, mp):
        import torch.distributed as dist
        x = logits.float()
        V_loc = x.shape[-1]
        top = mp.all_reduce(x.max(dim=-1).values, op=dist.ReduceOp.MAX)
        e = torch.exp(x - top.unsqueeze(-1))
        total = mp.all_reduce(e.sum(dim=-1))
        local = labels.long() - mp.rank * V_loc
        own = (local >= 0) & (local < V_loc)
        idx = local.clamp(0, V_loc - 1).unsqueeze(-1)
        gold = mp.all_reduce(torch.where(
            own, x.gather(-1, idx).squeeze(-1), torch.zeros_like(top)))
        ctx.save_for_backward(e, total, idx, own)
        ctx.dtype = logits.dtype
        return torch.log(total) + top - gold

    @staticmethod
    def backward(ctx, g):
        e, total, idx, own = ctx.saved_tensors
        grad = e / total.unsqueeze(-1)
        grad.scatter_add_(-1, idx, -own.to(grad.dtype).unsqueeze(-1))
        return (grad * g.unsqueeze(-1)).to(ctx.dtype), None, None


def cross_entropy(logits, labels, mp=None):
    """logits [..., V]; labels [...] int -> scalar mean CE.  With ``mp``
    (a :class:`repro_torch.parallel.ModelParallel` of more than one
    rank) the logits are this rank's block of V, as a head split on V
    gives them."""
    if mp is not None and mp.active:
        return _VocabParallelCE.apply(logits, labels, mp).mean()
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
