"""Checkpointing (port of ``repro/checkpoint/io.py``): parameter trees <->
``.npz`` with path-encoded keys, and the server's ``meta.json``.

Keys are the ``/``-joined tree paths the JAX package writes (a dict key as
itself, a list or tuple position ``i`` as ``#i``), so ``state.npz``,
``ef.npz`` and ``meta.json`` have the JAX package's key layout.  Arrays are
stored in the port's own layout (conv weights OIHW, EF leaves in the
port's leaf order); :mod:`repro_torch.interop` maps parameter trees
between the two.  Every ``meta.json`` the port writes carries
``"layout": "repro_torch"`` (:data:`PORT_LAYOUT`), which the JAX package's
lacks.  ``None`` leaves (a stateless codec's EF state) are not written, as
JAX's tree flattening drops its empty ones.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["PORT_LAYOUT", "save_tree", "load_tree", "ef_disk_layout",
           "strip_scratch_rows", "insert_scratch_rows", "save_server_state",
           "restore_server_state"]

# meta.json marker of a directory the port wrote
PORT_LAYOUT = {"layout": "repro_torch"}

# transient-OSError retry for checkpoint writes (networked or overlaid
# filesystems throw sporadic EIO/ESTALE); a persistent failure still
# raises after the last attempt
_SAVE_ATTEMPTS = 3
_SAVE_BACKOFF_S = 0.05


def _retry_save(write, path: str, runlog=None) -> None:
    """``write()`` with retries on OSError; attempts beyond the first are
    counted on the run log (``checkpoint.save_retries``) with a
    ``checkpoint.save_retry`` warning."""
    for attempt in range(_SAVE_ATTEMPTS):
        try:
            write()
            return
        except OSError:
            if attempt == _SAVE_ATTEMPTS - 1:
                raise
            if runlog is not None:
                runlog.counter("checkpoint.save_retries", 1)
                runlog.warning("checkpoint.save_retry", path=path,
                               attempt=attempt + 1)
            time.sleep(_SAVE_BACKOFF_S * (2 ** attempt))


def _paths(tree, prefix=()):
    """(path, leaf) pairs in leaf order; None leaves are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"#{i}",))
    elif tree is not None:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str, tree, runlog=None) -> None:
    """Write ``tree`` (tensors or arrays, on any device) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {k: _host(v) for k, v in _paths(tree)}   # fetch once
    _retry_save(lambda: np.savez(path, **flat), path, runlog)


def load_tree(path: str, like, device=None):
    """Restore ``path`` into the structure of ``like``: each leaf a tensor
    with the ``like`` leaf's dtype, on ``device`` (default: the ``like``
    leaf's device, the CPU for numpy leaves)."""
    data = np.load(path)
    it = iter(_paths(like))

    def leaf(v):
        if v is None:
            return None
        key, _ = next(it)
        t = torch.from_numpy(np.array(data[key]))
        dev = device if device is not None else (
            v.device if isinstance(v, torch.Tensor) else "cpu")
        dtype = v.dtype if isinstance(v, torch.Tensor) else t.dtype
        return t.to(device=dev, dtype=dtype)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    return walk(like)


def strip_scratch_rows(tree, n_shards: int):
    """The sharded engine's resident EF layout -> the compact on-disk one.

    Each rank's block of the sharded table carries one scratch row
    (``[(N_loc + 1) * S, ...]`` over the ranks, the write sink of the
    in-place scatter, see ``repro_torch.engine.superstep``).  Checkpoints
    keep the single-device ``[N, ...]`` layout: this drops row ``N_loc``
    of every block.  Takes tensors or arrays (None leaves pass), returns
    numpy."""
    def one(x):
        if x is None:
            return None
        x = _host(x)
        blocks = x.reshape((n_shards, -1) + x.shape[1:])
        return blocks[:, :-1].reshape((-1,) + x.shape[1:])

    return [one(x) for x in tree]


def insert_scratch_rows(tree, n_shards: int):
    """Compact ``[N, ...]`` EF layout -> resident ``[(N/S + 1) * S, ...]``:
    a zero scratch row after every rank's block (dead state, written
    before any read, so zeros give what a run never checkpointed would
    hold).  ``N`` must divide over ``n_shards``."""
    def one(x):
        if x is None:
            return None
        x = _host(x)
        n = x.shape[0]
        if n % n_shards:
            raise ValueError(f"EF table rows {n} do not divide over "
                             f"{n_shards} shards")
        blocks = x.reshape((n_shards, n // n_shards) + x.shape[1:])
        pad = np.zeros((n_shards, 1) + x.shape[1:], x.dtype)
        return np.concatenate([blocks, pad], axis=1).reshape(
            (-1,) + x.shape[1:])

    return [one(x) for x in tree]


def ef_disk_layout(ef, *, n_shards: int = 1, n_clients: int = None):
    """Any engine EF backing as the compact on-disk ``[N, ...]`` layout:
    the dense table (as numpy), the sharded resident table (``n_shards >
    1``: scratch rows dropped) or a cohort-paged store (anything with
    ``to_dense(n_clients)``, i.e.
    :class:`repro_torch.engine.efstore.HostEFStore`), so a checkpoint
    resumes under any store and any number of ranks."""
    if hasattr(ef, "to_dense"):
        if n_clients is None:
            raise ValueError("paged EF store needs n_clients to rebuild "
                             "the dense disk layout")
        return ef.to_dense(n_clients)
    if n_shards > 1:
        return strip_scratch_rows(ef, n_shards)
    return [None if x is None else _host(x) for x in ef]


def save_server_state(dirpath: str, global_state, round_idx: int,
                      extra: Dict | None = None, runlog=None) -> None:
    os.makedirs(dirpath, exist_ok=True)
    save_tree(os.path.join(dirpath, "state.npz"), global_state, runlog)
    meta = {"round": round_idx, **(extra or {}), **PORT_LAYOUT}
    meta_path = os.path.join(dirpath, "meta.json")

    def write_meta():
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    _retry_save(write_meta, meta_path, runlog)


def restore_server_state(dirpath: str, like, device=None) -> Tuple[Any, int]:
    state = load_tree(os.path.join(dirpath, "state.npz"), like, device)
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    return state, meta["round"]
