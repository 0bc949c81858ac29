"""Resume the port from a checkpoint the JAX package wrote.

The JAX package's ``checkpoint/io.py`` writes ``state.npz``, ``ef.npz`` and
``meta.json`` with the same keys as the port (``/``-joined tree paths), but
its arrays are in JAX's layout:

* the CNNs' conv weights are HWIO (the port's are OIHW), in the state and
  in the broadcast mirror (``ef.npz``'s ``#1/...`` entries);
* EF leaf ``i`` (``ef.npz``'s ``#0/#i``, ``[N, n]``) is model leaf ``i`` in
  JAX's leaf order, which sorts a dict's keys, and each row is that leaf
  flattened in JAX's layout;
* FedFusion's ``fusion`` entries carry over unchanged.

A directory is read in JAX's layout only when the caller says so
(``from_jax=True`` on the server loops) and its ``meta.json`` lacks the
port's marker: every save the port makes adds ``"layout": "repro_torch"``
(:data:`PORT_LAYOUT`), so a directory the port wrote, or resumed from a
JAX checkpoint and saved again, is read in the port's layout.  The
layout is never guessed from the arrays' shapes.

``ctrl.npz`` (an adaptive controller's state: 0-d level, EMA, spend) has
no layout to convert: :func:`load_ctrl` reads it the same way from either
package's directory.

Both packages write ``ef.npz`` in the compact ``[N, n]`` layout, sharded
or not (the sharded engines drop their scratch rows at save and put them
back on resume, ``repro_torch.checkpoint.io.insert_scratch_rows``), so a
JAX checkpoint resumes onto a sharded run as onto one device.  An EF
table whose row count is not the federation's is refused.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import (PORT_LAYOUT, _paths, load_tree,
                                       restore_server_state)
from repro_torch.interop import state_from_numpy
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["PORT_LAYOUT", "jax_layout", "load_ctrl", "load_ef",
           "load_jax_ef", "restore", "restore_jax_server_state"]


def jax_layout(dirpath: str, from_jax: bool) -> bool:
    """Whether ``dirpath``'s checkpoint is to be read in JAX's layout."""
    if not from_jax:
        return False
    with open(os.path.join(dirpath, "meta.json")) as f:
        return json.load(f).get("layout") != PORT_LAYOUT["layout"]


def _to_port(raw, like, device):
    """A tree loaded in JAX's layout -> the port's layout on ``device``
    (default: the ``like`` leaves' device)."""
    if device is None:
        device = tree_leaves(like)[0].device
    return state_from_numpy(tree_map(torch.Tensor.numpy, raw), device)


def restore_jax_server_state(dirpath: str, like, device=None
                             ) -> Tuple[Any, int]:
    """``(state, round)`` from a JAX checkpoint directory, in the port's
    layout and ``like``'s structure and dtypes, on ``device`` (default:
    the ``like`` leaves' device)."""
    raw = load_tree(os.path.join(dirpath, "state.npz"), like, "cpu")
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    return _to_port(raw, like, device), meta["round"]


def _jax_leaf_paths(tree, prefix=()):
    """Leaf paths in JAX's flattening order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaf_paths(v, prefix + (f"#{i}",))
    else:
        yield "/".join(prefix), tree


def load_jax_ef(path: str, ef_like, mirror_like, device=None):
    """``(ef, mirror)`` from a JAX ``ef.npz``, on ``device`` (default: the
    ``mirror_like`` leaves' device): ``ef`` one ``[N, n]`` tensor per port
    EF leaf (None where ``ef_like`` has None: a stateless codec) in the
    port's leaf order and flat layout, ``mirror`` the broadcast mirror in
    the port's layout."""
    if device is None:
        device = tree_leaves(mirror_like)[0].device
    order = [p for p, _ in _jax_leaf_paths(mirror_like)]
    ef = []
    with np.load(path) as data:
        for (p, leaf), like in zip(_paths(mirror_like), ef_like):
            if like is None:
                ef.append(None)
                continue
            rows = np.array(data[f"#0/#{order.index(p)}"])
            n_rows = like.shape[0]
            if rows.shape[0] != n_rows:
                raise ValueError(
                    f"{path}: EF table {p!r} has {rows.shape[0]} rows, not "
                    f"the federation's {n_rows}: the checkpoint belongs to "
                    "another federation")
            if "convs" in p.split("/") and p.endswith("/w"):
                o, i, h, w = leaf.shape            # JAX rows are HWIO
                rows = rows.reshape(n_rows, h, w, i, o).transpose(
                    0, 4, 3, 1, 2)
            ef.append(torch.from_numpy(
                np.ascontiguousarray(rows.reshape(n_rows, -1))).to(device))
    _, raw = load_tree(path, ([None] * len(ef_like), mirror_like), "cpu")
    return ef, _to_port(raw, mirror_like, device)


def restore(dirpath: str, like, device, *, from_jax: bool):
    """``(state, round, jax)``: the server state of ``dirpath``, read in
    JAX's layout where :func:`jax_layout` says so (``jax``), else in the
    port's."""
    jax = jax_layout(dirpath, from_jax)
    read = restore_jax_server_state if jax else restore_server_state
    return (*read(dirpath, like, device), jax)


def load_ef(path: str, ef_like, mirror_like, device, *, jax: bool):
    """``(ef, mirror)`` of ``ef.npz`` in the layout :func:`restore` found,
    on ``device``."""
    if jax:
        return load_jax_ef(path, ef_like, mirror_like, device)
    return load_tree(path, (ef_like, mirror_like), device)


def load_ctrl(path: str, like, device):
    """A controller state (``ctrl.npz``, written by either package: 0-d
    arrays under the state's keys) in the structure and dtypes of
    ``like``, on ``device``."""
    return load_tree(path, like, device)
