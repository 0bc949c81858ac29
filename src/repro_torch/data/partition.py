"""The paper's client-partition schemes for images (§4.1), and the
by-source split of token data, copied from ``repro/data/partition.py``
with the same numpy rng streams."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(x, y, n_clients, *, seed=0) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    splits = np.array_split(perm, n_clients)
    return [{"x": x[s], "y": y[s]} for s in splits]


def artificial_noniid_partition(x, y, n_clients, *, shards_per_client=2,
                                seed=0) -> List[Dict[str, np.ndarray]]:
    """Sort by label, split into shards, deal ``shards_per_client`` to each
    client (paper: 200 shards of 300 -> 100 clients x 2 shards; and the
    2-client binary split = 1 shard of 5 classes each)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(y, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        ids = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        idx = np.concatenate([shards[i] for i in ids])
        out.append({"x": x[idx], "y": y[idx]})
    return out


def class_split_partition(x, y, n_clients, *, n_classes=10
                          ) -> List[Dict[str, np.ndarray]]:
    """Paper §4.2.1: split the classes into ``n_clients`` disjoint sets
    (e.g. CIFAR-10 5+5 for two clients)."""
    classes = np.array_split(np.arange(n_classes), n_clients)
    out = []
    for cs in classes:
        idx = np.isin(y, cs)
        out.append({"x": x[idx], "y": y[idx]})
    return out


def permuted_partition(x, y, n_clients, *, seed=0
                       ) -> List[Dict[str, np.ndarray]]:
    """User-specific non-IID (§4.3.2): each client sees the same data under
    a fixed client-specific pixel permutation (Permuted MNIST)."""
    rng = np.random.default_rng(seed)
    base = iid_partition(x, y, n_clients, seed=seed)
    H, W, C = x.shape[1:]
    out = []
    for c, part in enumerate(base):
        perm = rng.permutation(H * W * C)
        xf = part["x"].reshape(len(part["x"]), -1)[:, perm]
        out.append({"x": xf.reshape(part["x"].shape), "y": part["y"],
                    "perm": perm})
    return out


def source_partition(tokens, src, n_clients, *, sources_per_client=1,
                     seed=0) -> List[Dict[str, np.ndarray]]:
    """Non-IID LM partition: each client gets sequences from a subset of
    sources (analogue of the class-shard split for token data)."""
    rng = np.random.default_rng(seed)
    n_sources = int(src.max()) + 1
    src_ids = rng.permutation(n_sources)
    out = []
    for c in range(n_clients):
        take = src_ids[(c * sources_per_client) % n_sources:
                       (c * sources_per_client) % n_sources
                       + sources_per_client]
        idx = np.isin(src, take)
        out.append({"tokens": tokens[idx]})
    return out
