"""New-client generalization probe (port of ``repro/fl/newclient.py``;
paper Fig. 6).

When a fresh client joins, how many *local epochs* does it need to converge
on its own data, starting from the aggregated global state?  FedFusion's
fusion module gives the newcomer a ready-made mixer between the global
features and its soon-to-be-personal features: the paper's claimed
initialization advantage.

Each epoch trains on ``n // batch`` batches drawn by the JAX package's
numpy stream (``default_rng(seed).permutation(n)``), then evaluates the
whole client set through the plugin's ``deploy_logits`` hook without
gradients.  The state stays on the global state's device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import accuracy, make_local_trainer
from repro_torch.fl.api import make_algorithm
from repro_torch.models.registry import ModelBundle
from repro_torch.tree import tree_leaves

__all__ = ["newclient_convergence", "newclient_epochs"]


def newclient_convergence(bundle: ModelBundle, fl: FLConfig, global_state,
                          client_data: Dict[str, np.ndarray], *,
                          epochs: int, batch: int, lr: float,
                          seed: int = 0) -> List[float]:
    """Train locally for ``epochs`` epochs; returns per-epoch local accuracy."""
    return [acc for _, acc in newclient_epochs(
        bundle, fl, global_state, client_data, epochs=epochs, batch=batch,
        lr=lr, seed=seed)]


def newclient_epochs(bundle: ModelBundle, fl: FLConfig, global_state,
                     client_data: Dict[str, np.ndarray], *,
                     epochs: int, batch: int, lr: float, seed: int = 0
                     ) -> Iterator[Tuple[dict, float]]:
    """:func:`newclient_convergence`'s epochs, one at a time: yields the
    newcomer's state after each epoch and its local accuracy."""
    rng = np.random.default_rng(seed)
    algo = make_algorithm(fl.algorithm)
    trainer = make_local_trainer(bundle, fl)
    device = tree_leaves(global_state)[0].device
    key = "x" if "x" in client_data else "tokens"
    n = len(client_data[key])
    steps = max(n // batch, 1)

    @torch.no_grad()
    def epoch_eval(state, eval_batch):
        out = bundle.apply(state["model"], eval_batch)
        logits = algo.deploy_logits(bundle, fl, state, out)
        return accuracy(logits, bundle.labels(eval_batch))

    state = dict(global_state)
    eval_batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in client_data.items()}
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    for _ in range(epochs):
        idx = rng.permutation(n)[: steps * batch].reshape(steps, batch)
        batches = {k: torch.from_numpy(np.asarray(v)[idx]).to(device)
                   for k, v in client_data.items()}
        trainable, _ = trainer(state["model"], algo.extra_from_state(state),
                               batches, lr_t)
        state = {k: trainable[k] for k in ("model",) + algo.extra_state}
        yield state, float(epoch_eval(state, eval_batch))
