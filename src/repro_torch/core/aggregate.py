"""Server-side aggregation (port of ``repro/core/aggregate.py``; paper
Alg. 1 / Alg. 2 line 7).

Every aggregation takes an optional ``shard``, a :class:`ClientSharding`
saying how the round's client axis is split over ranks of a
``torch.distributed`` group.  With ``shard=None`` (the default, and the
only mode on one device) each function is the single-device code: an
in-process reduction with no collective.  With a shard, each function
reduces this rank's clients and finishes with an ``all_reduce`` over the
client group: the only cross-rank traffic FedAvg needs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class ClientSharding:
    """How the round's client axis maps onto the ranks of ``group``.

    ``axes`` / ``sizes``: the mesh axes the client dimension is split over
    (major to minor, e.g. ``("pod", "data")``) and their sizes.
    ``position`` is this rank's row-major index over those axes, a Python
    int fixed for the process (the JAX package traces it inside
    ``shard_map``); by default the rank's index in ``group``.
    ``collectives`` counts the all-reduces issued through :meth:`all_reduce`
    (like the kernels' ``launches``: it ticks when Python issues one, so a
    captured graph's count is taken during capture).
    """

    def __init__(self, axes: Tuple[str, ...], sizes: Tuple[int, ...],
                 group=None, position: Optional[int] = None):
        self.axes = tuple(axes)
        self.sizes = tuple(int(s) for s in sizes)
        self.group = group
        if position is None:
            import torch.distributed as dist
            position = dist.get_rank(group) if group is not None else 0
        self.position = int(position)
        self.collectives = 0

    @property
    def n_shards(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the client group, in place; returns ``t``."""
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        self.collectives += 1
        return t

    def __repr__(self):
        return (f"ClientSharding(axes={self.axes}, sizes={self.sizes}, "
                f"position={self.position})")


def _summed(x: torch.Tensor, shard: ClientSharding) -> torch.Tensor:
    out = x.clone() if x.dim() else x.reshape(1).clone()
    shard.all_reduce(out)
    return out.reshape(x.shape)


def psum_tree(tree, shard: Optional[ClientSharding]):
    """Sum every leaf over the client group, one ``all_reduce`` per leaf
    (identity when unsharded).  Leaves are not modified."""
    if shard is None:
        return tree
    return tree_map(lambda x: _summed(x, shard), tree)


def fused_psum(tree, shard: Optional[ClientSharding]):
    """Sum every leaf over the client group in ONE ``all_reduce``.

    The leaves are raveled into a single flat buffer, summed once and
    handed back as views at static offsets, so any number of quantities
    ride one collective.  Identity when unsharded.

    Each element is the sum of the ranks' values in an order the backend
    chooses from the element's place in the buffer and the buffer's size
    (gloo's and NCCL's ring or tree schedules cut the buffer into chunks).
    At two ranks every order gives a + b = b + a exactly, so a packed leaf
    is bitwise what its own ``all_reduce`` gives; at more ranks packing
    moves elements between chunks and the two agree to float rounding.
    Every rank receives the same bits either way.

    All leaves must share one dtype (the engine's fused buffers are
    float32 throughout); a mixed-dtype tree raises ``TypeError`` rather
    than promote through the concatenation.
    """
    if shard is None:
        return tree
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    dtypes = {str(x.dtype) for x in leaves}
    if len(dtypes) > 1:
        raise TypeError(
            f"fused_psum needs a single-dtype tree, got {sorted(dtypes)}; "
            "run the unfused collectives (fused_collective=False) for "
            "mixed-precision buckets")
    flat = torch.cat([x.reshape(-1) for x in leaves])
    shard.all_reduce(flat)
    out, off = [], 0
    for x in leaves:
        n = x.numel()
        out.append(flat[off:off + n].view(x.shape))
        off += n
    return tree_unflatten(tree, out)


def normalize_weights(n_examples, shard: Optional[ClientSharding] = None):
    n = n_examples.float()
    if shard is None:
        return n / n.sum()
    return n / _summed(n.sum(), shard)


def weighted_mean(stacked_tree, weights,
                  shard: Optional[ClientSharding] = None):
    """stacked_tree: tree with a leading client axis; weights [n_clients]
    (normalized over the whole round).  Sharded, the tensordot reduces this
    rank's clients and the all-reduce completes the round's sum."""
    local = tree_map(
        lambda x: torch.tensordot(weights.to(x.dtype), x, dims=1),
        stacked_tree)
    return psum_tree(local, shard)


def mean_over_clients(values, shard: Optional[ClientSharding] = None):
    """Mean of a per-client [C_local] tensor over the FULL round's
    clients (the JAX package's ``pmean`` when sharded)."""
    m = values.mean()
    if shard is None:
        return m
    return _summed(m, shard) / shard.n_shards


def masked_loss(losses, pmask):
    """Participation-masked mean of a per-client [C] loss (the JAX
    package's ``masked_loss_sums`` + ``finish_masked_loss`` on one
    device): the surviving clients' sum over their count, at least 1."""
    m = pmask.to(losses.dtype)
    return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_loss_sums(losses, pmask):
    """All-reduce-pending numerator and denominator of a participation-
    masked mean loss; they ride the collective the round already makes."""
    m = pmask.to(losses.dtype)
    return {"lsum": (losses * m).sum(), "lw": m.sum()}


def finish_masked_loss(summed):
    """:func:`masked_loss_sums` completed: divided once, after the sum
    over every rank's surviving clients."""
    return summed["lsum"] / torch.clamp(summed["lw"], min=1.0)


def running_update(acc_tree, tree, weight):
    """acc += weight * tree   (client_sequential accumulation), in place
    on ``acc_tree``'s leaves (the round's own sums; the same roundings as
    ``acc + weight * tree``), which it returns."""
    return tree_map(lambda a, x: a.add_(weight.to(x.dtype) * x), acc_tree,
                    tree)


def zeros_like_tree(tree):
    return tree_map(torch.zeros_like, tree)
