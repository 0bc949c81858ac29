"""On-device (client-side) training (port of ``repro/core/local.py``).

A client receives the global model, builds its *trainable* state (local
model copy + the algorithm plugin's extra state), and runs
``fl.local_epochs x fl.local_steps`` optimizer steps on the plugin's
objective.  Gradients come from ``torch.autograd.grad``; the optimizer
update runs under ``torch.no_grad()``, in place on the client's own copy
of its trainable state (made once, before its first step), so a client
holds one copy of its model beside its gradient.  Optimizer state starts
fresh for every client every round, as in the JAX package.

The frozen global stream is never updated during local training.  With
``local_epochs > 1`` two-stream algorithms use the paper-§3.3 cache: the
global stream's features for the round's batches are computed once and
reused across epochs.

FSDP (an LM bundle whose ``tp.fsdp`` splits leaves over ``data``,
``repro_torch.parallel``): the trainable state is this rank's blocks, the
plugin's loss is this rank's estimate of the client's loss (its rows'
mean, the whole batch's MMD and MoE aux terms), and the client's loss is
their mean over the data ranks.  So each rank backpropagates its
estimate over the data size; the gradients of the leaves split over
``data`` come summed out of their gathers, the others are summed over
``data`` after the backward (``parallel.sum_over_data``), and the step's
loss is the all-reduced mean.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sum_over_data
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _algorithm(fl: FLConfig):
    from repro_torch.fl.api import make_algorithm
    return make_algorithm(fl.algorithm)


def make_local_loss(bundle: ModelBundle, fl: FLConfig):
    algo = _algorithm(fl)

    def loss_fn(trainable, global_model, batch, cached_feats_g=None):
        return algo.local_loss(bundle, fl, trainable, global_model, batch,
                               cached_feats_g)

    return loss_fn


def make_local_trainer(bundle: ModelBundle, fl: FLConfig):
    """Returns local_train(global_model, global_extra, batches, lr) ->
    (trainable, mean_loss).

    ``batches``: dict whose tensors have a leading step dim, one local step
    per slice (``fl.local_steps`` in a round; the new-client probe passes
    an epoch's worth).  ``mean_loss`` is a 0-d tensor (no host
    sync).
    """
    algo = _algorithm(fl)
    opt_init, opt_update = make_optimizer(fl.optimizer, fl.momentum)
    loss_fn = make_local_loss(bundle, fl)
    cache = (fl.cache_global_features and algo.two_stream
             and fl.local_epochs > 1)

    tp = getattr(bundle, "tp", None)

    def step(trainable, state, global_model, batch, lr, feats_g):
        n_data = 1 if tp is None else tp.data_size
        trainable = tree_map(lambda p: p.detach().requires_grad_(True),
                             trainable)
        loss, _ = loss_fn(trainable, global_model, batch, feats_g)
        leaves = tree_leaves(trainable)
        grads = torch.autograd.grad(loss / n_data if n_data > 1 else loss,
                                    leaves, allow_unused=True)
        # an unused leaf has zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if n_data > 1:
            grads = sum_over_data(grads, trainable,
                                  {k: tp.specs[k] for k in trainable}, tp)
            loss = tp.mp.all_reduce(loss.detach().clone(), group=tp.mp.place(
                ("data",))[0]) / n_data
        with torch.no_grad():
            trainable, state = opt_update(
                tree_map(torch.Tensor.detach, trainable),
                tree_unflatten(trainable, grads), state, lr)
        return trainable, state, loss.detach()

    def local_train(global_model, global_extra, batches, lr):
        trainable: Dict[str, Any] = tree_map(
            lambda t: t.detach().clone(),
            algo.init_trainable(fl, global_model, global_extra))
        state = opt_init(trainable)
        n_steps = len(next(iter(batches.values())))
        steps = [{k: v[s] for k, v in batches.items()}
                 for s in range(n_steps)]
        cached = [None] * len(steps)
        if cache:
            with torch.no_grad():
                cached = [bundle.extract(global_model, b)[0] for b in steps]
        losses = []
        for _ in range(fl.local_epochs):
            for batch, feats_g in zip(steps, cached):
                trainable, state, loss = step(trainable, state, global_model,
                                              batch, lr, feats_g)
                losses.append(loss)
        return trainable, torch.stack(losses).mean()

    return local_train
