"""Carries parameter trees between the JAX package and the port.

The trees have the same keys on both sides: the federated state
(``{"model": {"convs": [{"w", "b"}...], "fcs": [...], "head": {...}},
"fusion": {...}}``) and the transformers' parameter and KV-cache trees
(``{"embed", "final_norm", "cycles": (...), "tail": (...)}``, with
``"head"``, the VLM's ``"vis_proj"`` and the encoder-decoder's ``"enc"``
(its ``"layers"`` stacked on a leading axis) where the model has them;
tuples kept as tuples).  The only layout difference is the CNNs' conv weights: the JAX
package stores them HWIO, the port OIHW; every other leaf carries across
unchanged.  Pull a JAX tree to numpy first
(``jax.tree.map(np.asarray, tree)``); this module imports numpy and torch
only.
"""
from __future__ import annotations

import numpy as np
import torch


def _convert(tree, conv_w, leaf):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "convs":
                out[k] = [{ck: (conv_w(cv) if ck == "w" else leaf(cv))
                           for ck, cv in conv.items()} for conv in v]
            else:
                out[k] = _convert(v, conv_w, leaf)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, conv_w, leaf) for v in tree)
    return leaf(tree)


def state_from_numpy(tree, device="cpu"):
    """A numpy tree from the JAX package (a global state or a bare params
    tree) -> the port's tree of float tensors on ``device``."""
    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def conv_w(a):      # HWIO -> OIHW
        return leaf(np.ascontiguousarray(np.transpose(np.asarray(a),
                                                      (3, 2, 0, 1))))

    return _convert(tree, conv_w, leaf)


def state_to_numpy(tree):
    """The inverse of :func:`state_from_numpy`: the port's tree -> numpy
    arrays in the JAX package's layout."""
    def leaf(t):
        return t.detach().cpu().numpy()

    def conv_w(t):      # OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(leaf(t), (2, 3, 1, 0)))

    return _convert(tree, conv_w, leaf)
