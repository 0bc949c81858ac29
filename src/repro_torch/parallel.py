"""Tensor parallelism over the mesh's ``model`` axis and FSDP over its
``data`` axis: the autograd-aware collectives a transformer split over the
mesh runs, and the context that carries a rank's place and its layouts
into the model.  The models and the round code import this module; it
imports nothing of the launchers.

The JAX package states its LM layouts as ``PartitionSpec``s
(``repro_torch.launch.sharding`` ports them) and lets GSPMD insert the
collectives.  Here every rank holds its block of each leaf and the
collectives are explicit, Megatron-style:

* :func:`copy_to_model` (identity forward, all-reduce backward) goes before
  a column-parallel product whose input is replicated, and before a
  replicated leaf of which a rank uses only its slice (its gradient then
  sums the ranks' slices);
* :func:`reduce_from_model` (all-reduce forward, identity backward) goes
  after a row-parallel product;
* :func:`gather_from_model` (all-gather forward; a reduce-scatter
  backward, the sum over the ranks of this rank's block) joins column
  blocks whose
  consumers differ by rank: a row-parallel ``wo`` fed with this rank's
  block of the gathered heads, or the vocab-sharded head.  Its backward
  therefore receives partial gradients and sums them;
* :func:`gather_replicated` (all-gather forward, this rank's slice
  backward) joins column blocks that enter the replicated residual
  stream, whose gradient every rank already holds whole (the VLM's
  ``vis_proj``, the encoder's ``in_proj``);
* :func:`gather_from_data` is :func:`gather_from_model` over ``data``: an
  FSDP leaf gathered just before use (its gradient, partial on each data
  rank, which computed only its rows, is summed and sliced), a batch's
  rows gathered where a term needs all of them (FedMMD's pooled
  features, an MoE layer's tokens).

FSDP (``TensorParallel.fsdp``): the leaves split over ``data`` are
gathered where the model uses them (:func:`fsdp_gather`), each data rank
computes its share of a client's rows (``rows_split``; all of them where
``data`` does not divide the client's batch), and a local step's loss is
the mean over the data ranks of each rank's estimate of the client's
loss, so each rank backpropagates its estimate over the data size; the
gradients of the leaves not split over ``data`` are then summed over it
(:func:`sum_over_data`).

The collectives are ``all_reduce``, ``all_gather`` and
``all_to_all_single``: gloo (the CPU tests', and two ranks sharing one
card) has no reduce-scatter, so :meth:`ModelParallel.reduce_scatter`
sends each rank its block of the gradient with one all-to-all and sums
the blocks it receives, in rank order (half the bytes of an all-reduce,
and the sum on the device).  With one rank on an axis (or no context)
every function over it is the identity and makes no collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["ModelParallel", "TensorParallel", "copy_to_model",
           "reduce_from_model", "gather_from_model", "gather_replicated",
           "gather_from_data", "rows_to_columns", "columns_of_rows",
           "sum_onto_rows", "fsdp_gather", "sum_over_data",
           "model_dim", "data_dim", "spec_axes"]

Place = Tuple[Any, int, int]


class ModelParallel:
    """This rank's position and size on the mesh's ``model`` axis, its
    process group there, and groups over other sets of the mesh's axes
    (``data`` for FSDP, the ranks a sequence-sharded cache is split
    over).  ``place_fn(axes) -> (group, size, position)`` answers for the
    mesh (``repro_torch.launch.mesh.axes_place``); None is one rank.  A
    place is asked for on first use, so a context built on a mesh of axis
    sizes only (``launch.mesh.MeshSpec``) can be made, not run.
    ``collectives`` counts the collectives issued through it."""

    def __init__(self, place_fn: Optional[Callable[[tuple], Place]] = None):
        self._place_fn = place_fn
        self._places: Dict[Tuple[str, ...], Place] = {}
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
    def group(self):
        return self.place(("model",))[0]

    @property
    def size(self) -> int:
        return self.place(("model",))[1]

    @property
    def rank(self) -> int:
        return self.place(("model",))[2]

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

    def all_to_all(self, t, group=None):
        """Block j of ``t`` (dim 0 split in equal blocks) sent to rank j of
        ``group`` (the model group); block i of the result came from rank
        i."""
        import torch.distributed as dist
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group if group is None
                               else group)
        self.collectives += 1
        return out

    def reduce_scatter(self, t, dim, group=None, size=None):
        """This rank's block along ``dim`` of the sum of ``t`` over
        ``group`` (the model group): block j of ``t`` goes to rank j with
        one ``all_to_all_single``, and the n blocks received are summed in
        rank order."""
        n = self.size if size is None else size
        return self.all_to_all(torch.stack(t.chunk(n, dim=dim)),
                               group).sum(0)

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
    """All-gather over ``axes``; backward: a reduce-scatter (the
    consumers' gradients are partial: their sum's slice of this rank), or
    this rank's slice alone (``summed=False``: every rank holds the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, dim, mp, axes, summed):
        group, n, position = mp.place(axes)
        ctx.dim, ctx.mp, ctx.summed = dim, mp, summed
        ctx.group, ctx.n, ctx.position = group, n, position
        return mp.all_gather(x, dim, group=group, size=n)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.mp.reduce_scatter(g.contiguous(), ctx.dim,
                                      group=ctx.group, size=ctx.n)
        else:
            g = g.chunk(ctx.n, dim=ctx.dim)[ctx.position].contiguous()
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """:meth:`ModelParallel.all_to_all` over ``group``; the exchange is its
    own transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mp, group):
        ctx.mp, ctx.group = mp, group
        return mp.all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_to_all(g, ctx.group), None, None


def rows_to_columns(cols, mp: ModelParallel):
    """FSDP's transpose over ``data``: from this rank's column block
    [n * B, ..., c] of every data rank's rows (rank j's rows block j, in
    rank order) to its own rows' whole width [B, ..., n * c] (rank j's
    columns block j), with one all-to-all; the backward is the reverse
    exchange."""
    group, n, _ = mp.place(("data",))
    x = _AllToAll.apply(cols.reshape(n, -1, *cols.shape[1:]), mp, group)
    return x.movedim(0, -2).flatten(-2)


def columns_of_rows(x, mp: ModelParallel):
    """The inverse of :func:`rows_to_columns`: from this rank's rows' whole
    width [B, ..., n * c] to its column block [n * B, ..., c] of every
    data rank's rows, in rank order."""
    group, n, _ = mp.place(("data",))
    blocks = x.unflatten(-1, (n, -1)).movedim(-2, 0)
    return _AllToAll.apply(blocks, mp, group).flatten(0, 1)


def sum_onto_rows(partial, mp: ModelParallel):
    """Each data rank's partial sums [n * B, ...] of every rank's rows
    summed over ``data`` onto their own rank: [B, ...] (a reduce-scatter
    by rows, one all-to-all and a sum in rank order); the backward hands
    every rank all the rows' gradients."""
    group, n, _ = mp.place(("data",))
    return _AllToAll.apply(partial.unflatten(0, (n, -1)), mp,
                           group).sum(0)


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


def _gather(x, dim, mp, axes, summed):
    if mp is None or mp.place(axes)[1] == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), mp, axes, summed)


def gather_from_model(x, dim, mp: Optional[ModelParallel]):
    """All-gather along ``dim`` over ``model`` forward; backward sums the
    (partial, rank-dependent) gradient over ``model`` and keeps this rank's
    slice (a reduce-scatter)."""
    return _gather(x, dim, mp, ("model",), True)


def gather_replicated(x, dim, mp: Optional[ModelParallel]):
    """All-gather along ``dim`` over ``model`` forward for a replicated
    consumer (the residual stream): the backward keeps this rank's slice
    of the gradient every rank holds whole."""
    return _gather(x, dim, mp, ("model",), False)


def gather_from_data(x, dim, mp: Optional[ModelParallel]):
    """All-gather along ``dim`` over ``data`` forward; backward sums the
    gradient (each data rank's part, from its rows) over ``data`` and
    keeps this rank's slice: an FSDP leaf's reduce-scatter."""
    return _gather(x, dim, mp, ("data",), True)


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


def data_dim(spec) -> Optional[int]:
    """The dim a spec splits over ``data`` (an FSDP leaf), or None."""
    for d, entry in enumerate(spec):
        if "data" in spec_axes(entry):
            return d
    return None


def _without_data(spec) -> tuple:
    """``spec`` with ``data`` taken out of every entry."""
    def entry(e):
        axes = tuple(a for a in spec_axes(e) if a != "data")
        return None if not axes else (axes[0] if len(axes) == 1 else axes)
    return tuple(entry(e) for e in spec)


@dataclass
class TensorParallel:
    """What a model split over the mesh needs besides its blocks: the
    rank's :class:`ModelParallel`, the spec tree of the state the blocks
    were cut from (``launch.sharding.param_shardings`` of ``{"model":
    params, **the algorithm's extra state}``) and, for decode, of the
    cache (``sharding.cache_shardings``).  ``fsdp``: the leaves split over
    ``data`` are FSDP blocks, gathered before use; ``rows_split``: each
    data rank then trains on its share of a client's rows (module
    docstring).  The model functions take one as ``tp=``; None (or a mesh
    of one rank) runs the one-device code."""
    mp: ModelParallel
    specs: Any
    cache_specs: Any = None
    fsdp: bool = False
    rows_split: bool = False

    @property
    def active(self) -> bool:
        return self.mp.active

    @property
    def model_specs(self):
        """The specs of the model's parameters."""
        return self.specs["model"]

    @property
    def data_size(self) -> int:
        """The ranks an FSDP step splits leaves and rows over (1 without
        FSDP)."""
        return self.mp.place(("data",))[1] if self.fsdp else 1

    @property
    def data_rows(self) -> bool:
        """Whether this rank holds a share of the rows (FSDP with
        ``rows_split`` over more than one data rank)."""
        return self.rows_split and self.data_size > 1


def fsdp_gather(tree, specs, tp: Optional[TensorParallel], keep=None):
    """``(tree, specs)`` with every leaf split over ``data`` gathered
    (:func:`gather_from_data`) and ``data`` taken out of its spec, under an
    FSDP ``tp``; unchanged otherwise.  ``keep(spec) -> bool`` names leaves
    left split (the experts an all-to-all dispatch reaches where they
    live)."""
    if tp is None or tp.data_size == 1:
        return tree, specs

    def gathered(spec):
        return data_dim(spec) is not None and not (keep and keep(spec))

    return (_map_with_specs(
                lambda x, s: gather_from_data(x, data_dim(s), tp.mp)
                if gathered(s) else x, tree, specs),
            _map_with_specs(lambda _, s: _without_data(s) if gathered(s)
                            else s, tree, specs))


def _map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves, ``specs`` read along
    ``tree``'s structure (a spec is a tuple: the tree says where the
    leaves are)."""
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_specs(fn, v, specs[i])
                          for i, v in enumerate(tree))
    return fn(tree, specs)


def sum_over_data(grads, tree, specs, tp: Optional[TensorParallel]):
    """The gradients of ``tree``'s leaves (a list, in its leaf order) with
    those of the leaves NOT split over ``data`` under ``specs`` summed over
    it, in one all-reduce of a flat buffer: each data rank computed its
    part (its rows).  The split leaves' gradients come summed out of their
    :func:`gather_from_data`; with no FSDP the list is returned as it
    is."""
    if tp is None or tp.data_size == 1:
        return grads
    leaf_specs = []
    _map_with_specs(lambda _, s: leaf_specs.append(s), tree, specs)
    whole = [i for i, s in enumerate(leaf_specs) if data_dim(s) is None]
    if not whole:
        return grads
    flat = torch.cat([grads[i].reshape(-1) for i in whole])
    tp.mp.all_reduce(flat, group=tp.mp.place(("data",))[0])
    out, off = list(grads), 0
    for i in whole:
        n = grads[i].numel()
        out[i] = flat[off:off + n].view_as(grads[i])
        off += n
    return out
