"""K-round supersteps (port of ``repro/engine/superstep.py`` for one
device).

A superstep is a plain function that turns K pre-staged rounds: one
round body (``make_round_fn`` / ``make_compressed_round_fn``) called K
times.  Everything it reads arrives as a tensor, so nothing in it syncs
with the host and the engine can capture it once per chunk length as a
CUDA graph (the counterpart of the JAX package's ``jit`` + ``lax.scan``):

* ``batches [K, C, steps, B, ...]`` and ``sizes [K, C]`` are the chunk's
  sampled client data (``FederatedDataset.round_chunk``);
* ``lrs [K]`` is the learning-rate schedule: each round's ``lr`` enters
  the optimizer as a 0-d tensor, never as a Python float;
* on the compressed path, ``cids [K, C]`` selects each round's rows of
  the carried EF table: every round gathers them with ``ops.ef_gather``
  (K6) and writes the new residuals back with ``ops.ef_scatter`` (K7), in
  place, with no copy of the ``[N, n]`` table.  ``noise`` holds the quant
  codecs' stochastic-rounding offsets of the chunk, drawn outside (no
  random generator runs inside a captured graph);
* with partial participation, ``part = (pmask, pstale)`` ``[K, C]``
  carries each round's contribution mask and staleness (the round fns'
  participation inputs); None keeps the round without them;
* per-round metrics come back stacked ``[K]`` (each round's ``tele/...``
  telemetry values too); with ``eval_fn`` (eval every round) the
  evaluator is folded into each round;
* with an adaptive controller (``repro_torch.control``) the compressed
  superstep carries ``ctrl``, a dict of 0-d tensors, through its K rounds:
  round r encodes at the level round r - 1 chose, and the chunk's last
  state is copied into ``ctrl`` in place at the end (on the card its
  tensors are static buffers of the captured graph, like the mirror and
  the EF table).

The layout is agnostic of the EF backing: the cohort-paged store passes a
``[K*C, n]`` page and page-relative ids as ``ef_all`` and ``cids``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.rounds import make_compressed_round_fn, make_round_fn
from repro_torch.kernels import ops

__all__ = ["make_plain_superstep", "make_compressed_superstep"]


def _stack(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """K rounds' metric dicts -> one dict of [K] tensors."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _round_part(part, r):
    """Round ``r``'s (pmask, pstale), or () without participation."""
    return () if part is None else (part[0][r], part[1][r])


def make_plain_superstep(bundle, fl, mode, n_rounds, *, eval_fn=None,
                         telemetry=None):
    """Uncompressed K-round superstep.

    Returns ``superstep(global_state, batches, sizes, lrs[, test_batch,
    test_mask], part=None) -> (new_global_state, metrics stacked [K])``.
    ``eval_fn`` (``repro_torch.engine.make_eval_fn``) folds per-round
    evaluation of the post-round state into the chunk; ``telemetry`` goes
    to the round fn.
    """
    round_fn = make_round_fn(bundle, fl, mode, telemetry=telemetry)

    def superstep(global_state, batches, sizes, lrs, *test, part=None):
        state, ms = global_state, []
        for r in range(n_rounds):
            state, m = round_fn(state, {k: v[r] for k, v in batches.items()},
                                sizes[r], lrs[r], *_round_part(part, r))
            if eval_fn is not None:
                m = {**m, **eval_fn(state, test[0], test[1])}
            ms.append(m)
        return state, _stack(ms)

    return superstep


def make_compressed_superstep(bundle, fl, mode, n_rounds, uplink, downlink,
                              *, eval_fn=None, telemetry=None,
                              controller=None):
    """Compressed (codec-routed) K-round superstep.

    Returns ``superstep(global_state, ef_all, mirror, batches, sizes, lrs,
    cids, noise[, test_batch, test_mask], part=None, ctrl=None) ->
    (new_global_state, metrics [K], ef_all, new_mirror)``.

    ``ef_all``: per uplink leaf the federation's EF table ``[N, n]`` (or a
    chunk's page), updated in place; None for a stateless uplink.  ``cids
    [K, C]`` int32 selects each round's rows.  ``noise``: ``(down, up)``
    with ``down`` per leaf ``[K, n]`` and ``up`` per leaf ``[K, C, n]``
    (None for a codec without noise).  ``telemetry`` / ``controller`` go
    to the round fn; with a controller, ``ctrl`` (its state) is required
    and updated in place.
    """
    round_fn = make_compressed_round_fn(bundle, fl, mode, uplink, downlink,
                                        telemetry=telemetry,
                                        controller=controller)

    def superstep(global_state, ef_all, mirror, batches, sizes, lrs, cids,
                  noise, *test, part=None, ctrl=None):
        down_noise, up_noise = noise
        n_clients = sizes.shape[1]
        state, ms = global_state, []
        ctrl_state = ctrl
        for r in range(n_rounds):
            ef_round = (None if ef_all is None else
                        [ops.ef_gather(t, cids[r]) for t in ef_all])
            noise_r = (
                None if down_noise is None else [d[r] for d in down_noise],
                None if up_noise is None else
                [[u[r, c] for u in up_noise] for c in range(n_clients)])
            out = round_fn(
                state, {k: v[r] for k, v in batches.items()}, sizes[r],
                lrs[r], ef_round, mirror, noise_r, *_round_part(part, r),
                ctrl_state=ctrl_state)
            state, m, new_ef, mirror = out[:4]
            if controller is not None:
                ctrl_state = out[4]
            if ef_all is not None:
                for t, rows in zip(ef_all, new_ef):
                    ops.ef_scatter(t, cids[r], rows)
            if eval_fn is not None:
                m = {**m, **eval_fn(state, test[0], test[1])}
            ms.append(m)
        if controller is not None:
            for k, t in ctrl.items():
                t.copy_(ctrl_state[k])
        return state, _stack(ms), ef_all, mirror

    return superstep
