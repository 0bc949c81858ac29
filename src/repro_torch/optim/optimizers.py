"""Functional optimizers on parameter trees (port of
``repro/optim/optimizers.py``): SGD (+momentum, ``mu = m·mu + g``) and
Adam with bias correction.  Updates return new tensors; callers run them
under ``torch.no_grad()``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def sgd_init(params, momentum=0.0):
    if momentum == 0.0:
        return {"t": 0}
    return {"t": 0, "mu": tree_map(torch.zeros_like, params)}


def sgd_update(params, grads, state, *, lr, momentum=0.0):
    if momentum == 0.0:
        new = tree_map(lambda p, g: p - lr * g, params, grads)
        return new, {"t": state["t"] + 1}
    mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
    new = tree_map(lambda p, m: p - lr * m, params, mu)
    return new, {"t": state["t"] + 1, "mu": mu}


def adam_init(params):
    return {"t": 0,
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    new = tree_map(
        lambda p, m_, v_: p - lr * (m_ / c1) / ((v_ / c2).sqrt() + eps),
        params, m, v)
    return new, {"t": t, "m": m, "v": v}


def make_optimizer(kind: str, momentum: float = 0.0):
    """Returns (init_fn(params), update_fn(params, grads, state, lr))."""
    if kind == "sgd":
        return (lambda p: sgd_init(p, momentum),
                lambda p, g, s, lr: sgd_update(p, g, s, lr=lr,
                                               momentum=momentum))
    if kind == "adam":
        return adam_init, lambda p, g, s, lr: adam_update(p, g, s, lr=lr)
    raise ValueError(kind)
