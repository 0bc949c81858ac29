"""Optimizers on parameter trees (port of ``repro/optim/optimizers.py``):
SGD (+momentum, ``mu = m·mu + g``) and Adam with bias correction.  An
update writes the parameters and the optimizer state in place, leaf by
leaf, with the same roundings as JAX's functional update, and returns
them; the caller owns the parameter leaves it passes (not the global
model's) and runs the update under ``torch.no_grad()``.  Updating in
place keeps one copy of the model instead of two while the next is
built."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def sgd_init(params, momentum=0.0):
    if momentum == 0.0:
        return {"t": 0}
    return {"t": 0, "mu": tree_map(torch.zeros_like, params)}


def sgd_update(params, grads, state, *, lr, momentum=0.0):
    if momentum == 0.0:
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(lr * g)
        return params, {"t": state["t"] + 1}
    for p, m, g in zip(tree_leaves(params), tree_leaves(state["mu"]),
                       tree_leaves(grads)):
        p.sub_(lr * m.mul_(momentum).add_(g))
    return params, {"t": state["t"] + 1, "mu": state["mu"]}


def adam_init(params):
    return {"t": 0,
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(grads)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr * (m / c1) / ((v / c2).sqrt() + eps))
    return params, {"t": t, "m": state["m"], "v": state["v"]}


def make_optimizer(kind: str, momentum: float = 0.0):
    """Returns (init_fn(params), update_fn(params, grads, state, lr))."""
    if kind == "sgd":
        return (lambda p: sgd_init(p, momentum),
                lambda p, g, s, lr: sgd_update(p, g, s, lr=lr,
                                               momentum=momentum))
    if kind == "adam":
        return adam_init, lambda p, g, s, lr: adam_update(p, g, s, lr=lr)
    raise ValueError(kind)
