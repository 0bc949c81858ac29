"""The sharded engine's layouts (port of the engine-chunk half of
``repro/launch/sharding.py``).

The JAX package states a layout as a ``NamedSharding`` and lets the
runtime place the pieces; here every rank cuts its own piece out of the
whole, so each layout is a plain function on tensors or arrays.  The
tensor-parallel LM layouts of the JAX module (``param_pspec`` and the
batch, serve and cache shardings) belong to another slice.
"""
from __future__ import annotations

__all__ = ["client_axis_entry", "client_block", "ef_table_block",
           "eval_block"]


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
