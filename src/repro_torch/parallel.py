"""Tensor parallelism over the mesh's ``model`` axis: the autograd-aware
collectives a transformer split over ``model`` runs, and the context that
carries a rank's place and its layouts into the model.  The models and
the round code import this module; it imports nothing of the launchers.

The JAX package states its LM layouts as ``PartitionSpec``s
(``repro_torch.launch.sharding`` ports them) and lets GSPMD insert the
collectives.  Here every rank holds its block of each leaf and the
collectives are explicit, Megatron-style:

* :func:`copy_to_model` (identity forward, all-reduce backward) goes before
  a column-parallel product whose input is replicated;
* :func:`reduce_from_model` (all-reduce forward, identity backward) goes
  after a row-parallel product;
* :func:`gather_from_model` (all-gather forward; all-reduce then this
  rank's slice backward, a reduce-scatter) joins column blocks whose
  consumers differ by rank: a row-parallel ``wo`` fed with this rank's
  block of the gathered heads, or the vocab-sharded head.  Its backward
  therefore receives partial gradients and sums them.

The collectives are ``all_reduce`` and ``all_gather`` only: gloo (the CPU
tests', and two ranks sharing one card) has no reduce-scatter.  With one
rank on ``model`` (or no context) every function is the identity and
makes no collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["ModelParallel", "TensorParallel", "copy_to_model",
           "reduce_from_model", "gather_from_model", "model_dim",
           "spec_axes"]

Place = Tuple[Any, int, int]


class ModelParallel:
    """This rank's position and size on the mesh's ``model`` axis, its
    process group there, and groups over other sets of the mesh's axes
    (the ranks a sequence-sharded cache is split over).  ``place_fn(axes)
    -> (group, size, position)`` answers for the mesh
    (``repro_torch.launch.mesh.axes_place``); None is one rank.
    ``collectives`` counts the collectives issued through it."""

    def __init__(self, place_fn: Optional[Callable[[tuple], Place]] = None):
        self._place_fn = place_fn
        self._places: Dict[Tuple[str, ...], Place] = {}
        self.group, self.size, self.rank = self.place(("model",))
        self.collectives = 0

    def place(self, axes) -> Place:
        """``(group, size, position)`` over the mesh ``axes`` (major to
        minor): the group of the ranks that differ from this one only
        there (None for one rank), their count, and this rank's row-major
        index among them.  Groups are made on first use: every rank asks
        for the same axes in the same order."""
        axes = tuple(axes)
        if not axes or self._place_fn is None:
            return None, 1, 0
        if axes not in self._places:
            self._places[axes] = self._place_fn(axes)
        return self._places[axes]

    @property
    def active(self) -> bool:
        return self.size > 1

    def all_reduce(self, t, op=None, group=None):
        """Sum (or ``op``) ``t`` over ``group`` (the model group), in place."""
        import torch.distributed as dist
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM,
                        group=self.group if group is None else group)
        self.collectives += 1
        return t

    def all_gather(self, t, dim, group=None, size=None):
        """The blocks of ``t`` over ``group`` (the model group), joined
        along ``dim`` in the group's order."""
        import torch.distributed as dist
        n = self.size if size is None else size
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.group if group is None
                        else group)
        self.collectives += 1
        return torch.cat(parts, dim=dim)

    def __repr__(self):
        return f"ModelParallel(size={self.size}, rank={self.rank})"


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mp):
        ctx.dim, ctx.mp = dim, mp
        return mp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        mp = ctx.mp
        g = mp.all_reduce(g.contiguous().clone())
        return g.chunk(mp.size, dim=ctx.dim)[mp.rank].contiguous(), None, None


def copy_to_model(x, mp: Optional[ModelParallel]):
    """Identity forward; the gradient is all-reduced over ``model``."""
    if mp is None or not mp.active:
        return x
    return _Copy.apply(x, mp)


def reduce_from_model(x, mp: Optional[ModelParallel]):
    """All-reduce (sum) over ``model`` forward; identity backward."""
    if mp is None or not mp.active:
        return x
    return _Reduce.apply(x, mp)


def gather_from_model(x, dim, mp: Optional[ModelParallel]):
    """All-gather along ``dim`` over ``model`` forward; backward all-reduces
    the (partial, rank-dependent) gradient and keeps this rank's slice."""
    if mp is None or not mp.active:
        return x
    return _Gather.apply(x, dim % x.dim(), mp)


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry splits its dim over, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def model_dim(spec) -> Optional[int]:
    """The dim a spec splits over ``model``, or None."""
    for d, entry in enumerate(spec):
        if "model" in spec_axes(entry):
            return d
    return None


@dataclass
class TensorParallel:
    """What a model split over ``model`` needs besides its blocks: the
    rank's :class:`ModelParallel`, the spec tree of the state the blocks
    were cut from (``launch.sharding.param_shardings`` of ``{"model":
    params, **the algorithm's extra state}``) and, for decode, of the
    cache (``sharding.cache_shardings``).  The model functions take one as
    ``tp=``; None (or ``model`` of size 1) runs the one-device code."""
    mp: ModelParallel
    specs: Any
    cache_specs: Any = None

    @property
    def active(self) -> bool:
        return self.mp.active

    @property
    def model_specs(self):
        """The specs of the model's parameters."""
        return self.specs["model"]
