"""The client-parallel engine across ranks (port of
``repro/engine/sharded.py``).

The JAX package maps its superstep over a device mesh with ``shard_map``:
one controller traces one SPMD program.  The port has no ``shard_map``.
Every rank is its own process (``torchrun`` on a multi-GPU host, or the
CPU tests' worker processes over gloo), runs the same host loop, and
calls the shard-aware superstep of ``repro_torch.engine.superstep`` on its
own slice of the chunk; the collectives go through ``torch.distributed``
(NCCL on the card, gloo on the CPU).  What ``shard_map``'s partition specs
say in the JAX package, the staging says here
(``repro_torch.launch.sharding``):

* ``batches [K, C, ...]`` / ``sizes [K, C]`` (and ``pmask`` / ``pstale``,
  and the uplink's stochastic-rounding offsets) are split positionally:
  rank s trains sampled positions ``[s*C_loc, (s+1)*C_loc)`` of every
  round of the chunk;
* the federation's EF table is row-sharded by client id in the resident
  scratch-row layout (rank s holds its ``N_loc`` owned rows plus one
  write-sink row); under the cohort-paged store a chunk's page is split
  the same way (``[P_loc+1, n]`` a rank, ``P_loc = K*C``, a client's slot
  on rank ``cid % S``) and ``cids`` carries page-relative ids;
* the global state, the broadcast mirror, the learning rates, ``cids``
  and the controller state are replicated: every rank computes the same
  server-side update from the all-reduced sums, so they stay bitwise
  equal across ranks;
* the eval batch is split positionally when the evaluator is
  shard-aware (``sharded_eval=True``, the default: each rank forwards
  ``bucket / S`` examples), or evaluated whole on every rank;
* the traffic of a round is ONE all-reduce with ``fused_collective=True``
  (the default), or the unfused oracle's collectives with ``False``.

The mesh's ``model`` axis (if any) is replicated: the engine's CNN-scale
workloads are client-bound.  A mesh whose client axes multiply to 1 does
not come here: the engine keeps the plain superstep, so a one-rank run is
the single-device program.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.aggregate import ClientSharding
from repro_torch.engine.superstep import (make_compressed_superstep,
                                          make_plain_superstep)

__all__ = ["client_sharding", "make_sharded_superstep", "make_sharded_eval"]


def client_sharding(mesh) -> Optional[ClientSharding]:
    """The mesh's client-axis split for this rank, or None when the client
    axes multiply to 1.  ``mesh`` must be a
    ``torch.distributed.device_mesh.DeviceMesh`` (``TypeError`` else)."""
    from repro_torch.launch.mesh import client_group, client_position
    axes, sizes, position = client_position(mesh)
    n = 1
    for s in sizes:
        n *= s
    if n <= 1:
        return None
    return ClientSharding(axes, sizes, client_group(mesh), position)


def _one_shard_refusal(shard):
    if shard is None or shard.n_shards <= 1:
        raise ValueError("use the plain superstep on a 1-shard mesh "
                         "(client axes multiply to 1)")


def make_sharded_superstep(bundle, fl, mode, n_rounds, mesh, *, uplink=None,
                           downlink=None, eval_fn=None,
                           fused_collective=True, telemetry=None,
                           controller=None, shard=None):
    """This rank's shard-aware superstep on ``mesh`` (client axes > 1).

    Same call signature as the single-device supersteps; the plain one is
    built when ``uplink`` is None, the codec-routed one otherwise.  The
    caller stages this rank's slice of the chunk
    (``repro_torch.launch.sharding``) and its EF block.  ``eval_fn`` must
    match how the test batch is staged: shard-aware
    (``make_eval_fn(shard=...)`` on this rank's slice of a batch padded
    with ``pad_eval_batch(shard=...)``) or replicated.  ``shard`` reuses a
    :class:`ClientSharding` already built from ``mesh`` (its collective
    counter then counts this superstep's all-reduces too).
    """
    shard = shard if shard is not None else client_sharding(mesh)
    _one_shard_refusal(shard)
    if uplink is None:
        return make_plain_superstep(bundle, fl, mode, n_rounds,
                                    eval_fn=eval_fn, telemetry=telemetry,
                                    shard=shard, fused=fused_collective)
    return make_compressed_superstep(bundle, fl, mode, n_rounds, uplink,
                                     downlink, eval_fn=eval_fn,
                                     telemetry=telemetry,
                                     controller=controller, shard=shard,
                                     fused=fused_collective)


def make_sharded_eval(eval_fn, mesh, *, shard=None):
    """A shard-aware evaluator (``make_eval_fn(shard=...)``) for boundary
    evaluation on ``mesh``: the state is replicated, the padded batch and
    mask are this rank's positional slice, and the all-reduced metrics
    come back the same on every rank.  Without ``shard_map`` there is no
    wrapping to do; this checks the mesh and returns ``eval_fn``."""
    shard = shard if shard is not None else client_sharding(mesh)
    if shard is None or shard.n_shards <= 1:
        raise ValueError("sharded eval needs client axes > 1")
    return eval_fn
