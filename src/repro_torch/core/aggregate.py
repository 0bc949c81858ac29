"""Server-side aggregation, single device (port of the unsharded half of
``repro/core/aggregate.py``; paper Alg. 1 / Alg. 2 line 7)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def normalize_weights(n_examples):
    n = n_examples.float()
    return n / n.sum()


def weighted_mean(stacked_tree, weights):
    """stacked_tree: tree with a leading client axis; weights [n_clients]."""
    return tree_map(lambda x: torch.tensordot(weights.to(x.dtype), x, dims=1),
                    stacked_tree)


def mean_over_clients(values):
    """Mean of a per-client [C] tensor."""
    return values.mean()


def masked_loss(losses, pmask):
    """Participation-masked mean of a per-client [C] loss (the JAX
    package's ``masked_loss_sums`` + ``finish_masked_loss`` on one
    device): the surviving clients' sum over their count, at least 1."""
    m = pmask.to(losses.dtype)
    return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)


def running_update(acc_tree, tree, weight):
    """acc += weight * tree   (client_sequential accumulation)."""
    return tree_map(lambda a, x: a + weight.to(x.dtype) * x, acc_tree, tree)


def zeros_like_tree(tree):
    return tree_map(torch.zeros_like, tree)
