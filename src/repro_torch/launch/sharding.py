"""Layouts (port of ``repro/launch/sharding.py``): the tensor-parallel LM
half (``param_pspec`` and the train, serve and cache shardings) and the
engine-chunk half.

The JAX package states a layout as a ``NamedSharding`` and lets the
runtime place the pieces; here every rank cuts its own piece out of the
whole, so each layout is a plain function on tensors or arrays.  A
layout's spec is a tuple with one entry a dimension, as a JAX
``PartitionSpec`` has: ``None`` (whole), an axis name, or a tuple of
axis names (split over their product, major to minor).
:func:`local_block` cuts this rank's block, :func:`shard_tree` a tree's,
and :func:`gather_tree` puts the whole back together on every rank.

Three LM layouts, the JAX package's (DESIGN.md section 4):

* ``client_parallel`` train: params replicated over data/pod (each data
  group holds one client's replica), tensor-parallel over ``model``;
* ``client_sequential`` train: FSDP, the d_model-like dim of the large
  matrices also split over ``data``, MoE experts over ``data``;
* serve: tensor-parallel params; KV caches split over batch and cache
  length (flash-decode's sequence split where the batch alone cannot
  fill the mesh).

Every rule is divisibility-aware: a dim is split only where the axis size
divides it.  The rules read only the mesh's axis names and sizes, so each
takes a ``DeviceMesh`` or a :class:`repro_torch.launch.mesh.MeshSpec`.

Tree paths are the port's: a tuple of dict keys (``str``) and tuple
positions (``int``, named ``#i`` as the JAX package names a sequence
key).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.parallel import spec_axes
from repro_torch.tree import tree_with_path

__all__ = ["shard_if", "param_pspec", "param_shardings",
           "train_batch_shardings", "serve_batch_shardings",
           "cache_shardings", "replicated", "spec_axes", "local_block",
           "shard_tree", "gather_tree", "tree_with_path", "spec_at",
           "client_axis_entry", "client_block", "ef_table_block",
           "eval_block"]


def _axis(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 1)


def _fits(dim: int, mesh, name) -> bool:
    return name in axis_names(mesh) and dim % _axis(mesh, name) == 0


def shard_if(dim: int, mesh, name) -> Optional[str]:
    return name if _fits(dim, mesh, name) else None


def _names_of(path) -> list:
    return [f"#{p}" if isinstance(p, int) else str(p) for p in path]


# matrices whose FIRST dim is the contraction (d_model-like) axis and whose
# SECOND dim is model-parallel; and the transposed set
_COL_PARALLEL = {"wq", "wk", "wv", "w1", "w3", "w_x", "w_gate", "w_a", "w_i"}
_ROW_PARALLEL = {"wo", "w2", "w_out"}


def param_pspec(path, leaf, mesh, *, fsdp: bool,
                ep: Optional[bool] = None) -> tuple:
    """The spec of one parameter leaf (anything with a ``shape``) at tree
    path ``path``: the JAX package's rules, branch for branch."""
    names = _names_of(path)
    last = names[-1]
    shape = _shape(leaf)
    stacked = 1 if ("cycles" in names or "layers" in names) else 0
    fsdp_ax = "data" if fsdp else None
    ep = fsdp if ep is None else ep   # expert-parallel defaults to fsdp mode

    def spec(*dims):
        return tuple([None] * stacked + list(dims))

    # MoE experts: expert-parallel over data in fsdp / EP mode (the rank
    # check excludes the 2-D dense-residual MLP nested under "moe")
    if "moe" in names and last in ("w1", "w2", "w3") \
            and len(shape) - stacked == 3:
        e_ax = shard_if(shape[stacked], mesh, "data") if ep else None
        if last == "w2":  # [E, f, d]
            return spec(e_ax, shard_if(shape[stacked + 1], mesh, "model"),
                        None)
        return spec(e_ax, None, shard_if(shape[stacked + 2], mesh, "model"))
    if last == "table":  # embedding [V, d]
        return spec(shard_if(shape[stacked], mesh, "model"),
                    shard_if(shape[stacked + 1], mesh, fsdp_ax)
                    if fsdp else None)
    if "head" in names and last == "w":  # [d, V]
        return spec(shard_if(shape[stacked], mesh, fsdp_ax) if fsdp else None,
                    shard_if(shape[stacked + 1], mesh, "model"))
    if last == "w_in":  # ssd in-proj [d, mixed]: shard only the d side
        return spec(shard_if(shape[stacked], mesh, fsdp_ax) if fsdp else None,
                    None)
    if last in _COL_PARALLEL and len(shape) - stacked == 2:
        return spec(shard_if(shape[stacked], mesh, fsdp_ax) if fsdp else None,
                    shard_if(shape[stacked + 1], mesh, "model"))
    if last in _ROW_PARALLEL and len(shape) - stacked == 2:
        return spec(shard_if(shape[stacked], mesh, "model"),
                    shard_if(shape[stacked + 1], mesh, fsdp_ax)
                    if fsdp else None)
    if last == "w" and len(shape) - stacked == 2:  # generic proj (vis/fusion)
        return spec(None, shard_if(shape[stacked + 1], mesh, "model"))
    return tuple([None] * len(shape))


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's or array's, or the leaf itself where it
    is a shape (``torch.Size``)."""
    return tuple(getattr(leaf, "shape", leaf))


def param_shardings(mesh, params_struct, *, fsdp: bool,
                    ep: Optional[bool] = None):
    """The spec tree of a parameter (or global-state) tree."""
    return tree_with_path(
        lambda path, leaf: param_pspec(path, leaf, mesh, fsdp=fsdp, ep=ep),
        params_struct)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def _batch_axes_for(dim: int, mesh) -> Any:
    """Largest prefix of ('pod','data') whose product divides dim."""
    sizes = axis_sizes(mesh)
    chosen = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and dim % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def train_batch_shardings(mesh, batch_struct):
    """Leading dim = clients (client_parallel) or within-client batch dim
    at index 2 (client_sequential): dim 0 is split if it divides, else
    dim 2."""
    def rule(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        ax0 = _batch_axes_for(shape[0], mesh)
        if ax0 is not None:
            return tuple([ax0] + [None] * (len(shape) - 1))
        if len(shape) >= 3:
            ax2 = _batch_axes_for(shape[2], mesh)
            return tuple([None, None, ax2] + [None] * (len(shape) - 3))
        return tuple([None] * len(shape))

    return tree_with_path(rule, batch_struct)


def serve_batch_shardings(mesh, batch_struct):
    def rule(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        return tuple([_batch_axes_for(shape[0], mesh)]
                     + [None] * (len(shape) - 1))

    return tree_with_path(rule, batch_struct)


def cache_shardings(mesh, cache_struct):
    """KV caches [.., B, L, KV, hd]; SSD states; RG-LRU states.

    Batch splits over ('pod','data') when it divides; the cache length L
    also splits over 'model' (sequence-parallel flash-decode), since KV
    head counts (1..20) generally do not divide the model axis.  A batch
    of 1 splits L over every batch axis that divides it as well.
    """
    def rule(path, leaf):
        names = _names_of(path)
        shape = _shape(leaf)
        stacked = 1 if "cycles" in names else 0
        dims = [None] * len(shape)
        last = names[-1]
        if last in ("k", "v", "xk", "xv"):
            b, L = shape[stacked], shape[stacked + 1]
            dims[stacked] = _batch_axes_for(b, mesh)
            if dims[stacked] is None and b == 1:
                # batch-1 long context: shard L over everything that fits
                dims[stacked + 1] = _batch_axes_for(L, mesh)
            if _fits(L, mesh, "model"):
                merged = dims[stacked + 1]
                if merged is None:
                    dims[stacked + 1] = "model"
                elif isinstance(merged, tuple):
                    dims[stacked + 1] = merged + ("model",)
                else:
                    dims[stacked + 1] = (merged, "model")
        elif last == "h" and len(shape) - stacked == 4:   # SSD state [B,H,P,N]
            dims[stacked] = _batch_axes_for(shape[stacked], mesh)
            if _fits(shape[stacked + 2], mesh, "model"):
                dims[stacked + 2] = "model"
        elif last == "h":                                  # RG-LRU [B,W]
            dims[stacked] = _batch_axes_for(shape[stacked], mesh)
            if _fits(shape[stacked + 1], mesh, "model"):
                dims[stacked + 1] = "model"
        elif last == "conv":
            dims[stacked] = _batch_axes_for(shape[stacked], mesh)
            if _fits(shape[-1], mesh, "model"):
                dims[-1] = "model"
        return tuple(dims)

    return tree_with_path(rule, cache_struct)


def replicated(mesh, struct):
    return tree_with_path(lambda path, leaf: (), struct)


# ---------------------------------------------------------------------------
# Blocks: this rank's piece of the whole, and the whole back
# ---------------------------------------------------------------------------

def _block_index(entry, mesh):
    """(number of blocks, this rank's block) of a dim split by ``entry``."""
    from repro_torch.launch.mesh import axes_position
    axes = spec_axes(entry)
    if not axes:
        return 1, 0
    sizes, position = axes_position(mesh, axes)
    n = 1
    for s in sizes:
        n *= s
    return n, position


def local_block(x, spec, mesh):
    """This rank's block of ``x`` (a torch tensor or numpy array) under
    ``spec``: a view.  Dims past the spec's length are whole."""
    index = []
    for d, entry in enumerate(spec):
        n, i = _block_index(entry, mesh)
        if n == 1:
            index.append(slice(None))
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {n} blocks ({entry})")
        b = x.shape[d] // n
        index.append(slice(i * b, (i + 1) * b))
    return x[tuple(index)]


def shard_tree(tree, specs, mesh):
    """:func:`local_block` of every leaf of ``tree`` under ``specs`` (a
    tree of the same structure, specs at its leaves)."""
    return tree_with_path(
        lambda path, leaf: local_block(leaf, spec_at(specs, path), mesh),
        tree)


def spec_at(specs, path):
    """The spec at ``path`` of a spec tree."""
    for p in path:
        specs = specs[p]
    return specs


def _gather_dim(x, entry, d, mesh):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import axes_group
    n, _ = _block_index(entry, mesh)
    if n == 1:
        return x
    group = axes_group(mesh, spec_axes(entry))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=d)


def gather_tree(blocks, specs, mesh):
    """The whole of every leaf on every rank, from this rank's ``blocks``
    (torch tensors) under ``specs``: one ``all_gather`` a split dim, over
    the ranks that split it (for checkpoints and tests)."""
    def leaf(path, x):
        spec = spec_at(specs, path)
        for d, entry in enumerate(spec):
            x = _gather_dim(x, entry, d, mesh)
        return x

    return tree_with_path(leaf, blocks)


# ---------------------------------------------------------------------------
# Engine chunk layout (repro_torch.engine.sharded)
# ---------------------------------------------------------------------------

def client_axis_entry(mesh):
    """The axis entry a client-sharded dimension uses on ``mesh``: the
    client axes' names (a tuple when there are several), or None."""
    from repro_torch.launch.mesh import client_axes
    axes = client_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def client_block(x, shard, axis: int = 1):
    """This rank's positional block of a chunk array's client axis: rank
    ``s`` takes ``[s*C/S, (s+1)*C/S)`` (a view; numpy or torch).
    ``axis=1`` for the ``[K, C, ...]`` batches, sizes, ``pmask`` /
    ``pstale`` and uplink offsets."""
    if shard is None:
        return x
    c = x.shape[axis]
    if c % shard.n_shards:
        raise ValueError(f"client axis {c} does not divide over "
                         f"{shard.n_shards} shards")
    c_loc = c // shard.n_shards
    index = [slice(None)] * x.ndim
    index[axis] = slice(shard.position * c_loc, (shard.position + 1) * c_loc)
    return x[tuple(index)]


def ef_table_block(resident, shard):
    """This rank's ``[N/S + 1, n]`` block of a resident scratch-row table
    ``[(N/S + 1) * S, n]`` (``repro_torch.checkpoint.io.
    insert_scratch_rows``'s layout)."""
    rows = resident.shape[0] // shard.n_shards
    return resident[shard.position * rows:(shard.position + 1) * rows]


def eval_block(batch, mask, shard):
    """This rank's positional slice of a padded eval batch and its mask
    (pad with ``pad_eval_batch(shard=...)`` so the bucket divides)."""
    if shard is None:
        return batch, mask
    return ({k: client_block(v, shard, axis=0) for k, v in batch.items()},
            client_block(mask, shard, axis=0))
