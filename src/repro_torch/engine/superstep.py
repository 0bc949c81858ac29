"""K-round supersteps (port of ``repro/engine/superstep.py``).

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

Sharded mode (``shard``, a :class:`repro_torch.core.aggregate.
ClientSharding`; see ``repro_torch.engine.sharded``): the superstep runs
on one rank.  ``batches`` / ``sizes`` / ``part`` and the uplink offsets
carry this rank's positional slice of the round's clients, ``ef_all`` is
this rank's row block of the federation's table PLUS ONE RESIDENT
SCRATCH ROW (``[N_loc+1, n]``: rank s owns client ids ``[s*N_loc,
(s+1)*N_loc)``, row ``N_loc`` takes the writes of rows it does not own),
and ``cids`` stays the FULL round sample (a row's owner is decided by its
id, not by the rank that trains the client).  The scratch row stays in the
table for the whole run (``repro_torch.checkpoint.io`` drops it at save
and puts it back on resume), so each round's scatter is one in-place K7
launch on the block.  K6 and K7 move every row; rows a rank does not own
are masked (gather) or sent to the scratch row (scatter), so K7 sees
duplicate ids only there.

Collectives (sharded only):

* ``fused=False``: the unfused oracle: the round fn's all-reduces (one
  per leaf of each summed tree), plus one ``[C, n]`` all-reduce per EF
  leaf and direction (:func:`ef_gather_exchange` /
  :func:`ef_scatter_exchange`);
* ``fused=True`` (the engine's default): ONE all-reduce per round.  The
  round's local sums (``repro_torch.core.rounds.make_*_round_parts``),
  the EF scatter placement, the NEXT round's EF gather terms and the next
  round's example-count total are packed into one flat buffer
  (:func:`repro_torch.core.aggregate.fused_psum`).  What a round needs
  before it trains (its EF rows and weight total) rides the previous
  round's all-reduce; a per-chunk prologue all-reduce seeds round 0.  This
  works because ``cids`` and ``sizes`` are staged inputs and the rank
  that trained a client knows its fresh row before the scatter lands.  A
  K-round chunk makes K + 1 all-reduces, and per EF leaf K + 1 K6 launches
  (prologue plus one next-round gather a round) and K K7 launches.

There is no ``shard_map``: every rank runs these same functions in its
own process, so the ranks issue the same collectives in the same order.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.aggregate import fused_psum
from repro_torch.core.rounds import (make_compressed_round_fn,
                                     make_compressed_round_parts,
                                     make_round_fn, make_round_parts)
from repro_torch.kernels import ops

__all__ = ["make_plain_superstep", "make_compressed_superstep",
           "ef_gather_exchange", "ef_scatter_exchange"]


def _stack(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """K rounds' metric dicts -> one dict of [K] tensors."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _round_part(part, r):
    """Round ``r``'s (pmask, pstale), or () without participation."""
    return () if part is None else (part[0][r], part[1][r])


def _size_total(n_examples):
    """This rank's term of a round's example-count total (the local half
    of ``normalize_weights``; the all-reduce completes it, one round
    ahead)."""
    return n_examples.float().sum()


def _round_noise(noise, r, n_clients):
    down_noise, up_noise = noise
    return (None if down_noise is None else [d[r] for d in down_noise],
            None if up_noise is None else
            [[u[r, c] for u in up_noise] for c in range(n_clients)])


def _require_shard(fused, shard):
    if fused and shard is None:
        raise ValueError("fused collectives require a shard "
                         "(fused=True is sharded-only)")


def make_plain_superstep(bundle, fl, mode, n_rounds, *, eval_fn=None,
                         telemetry=None, shard=None, fused=False):
    """Uncompressed K-round superstep.

    Returns ``superstep(global_state, batches, sizes, lrs[, test_batch,
    test_mask], part=None) -> (new_global_state, metrics stacked [K])``.
    ``eval_fn`` (``repro_torch.engine.make_eval_fn``) folds per-round
    evaluation of the post-round state into the chunk; ``telemetry`` goes
    to the round fn.  ``shard`` / ``fused``: module docstring (under
    ``shard`` the test arguments are laid out as ``eval_fn`` expects:
    this rank's slice for a shard-aware evaluator, whole otherwise).
    """
    _require_shard(fused, shard)
    if fused:
        return _make_fused_plain_superstep(bundle, fl, mode, n_rounds,
                                           eval_fn=eval_fn,
                                           telemetry=telemetry, shard=shard)
    round_fn = make_round_fn(bundle, fl, mode, shard=shard,
                             telemetry=telemetry)

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


def _make_fused_plain_superstep(bundle, fl, mode, n_rounds, *, eval_fn,
                                telemetry, shard):
    """One all-reduce a round, uncompressed (sharded only)."""
    local_fn, finish_fn = make_round_parts(bundle, fl, mode, shard=shard,
                                           telemetry=telemetry)

    def superstep(global_state, batches, sizes, lrs, *test, part=None):
        # prologue: round 0's weight total (later rounds' ride the rounds)
        total = fused_psum({"total": _size_total(sizes[0])}, shard)["total"]
        state, ms = global_state, []
        for r in range(n_rounds):
            contribs = local_fn(state, {k: v[r] for k, v in batches.items()},
                                total, sizes[r], lrs[r],
                                *_round_part(part, r))
            summed = fused_psum(
                {"round": contribs,
                 "total": _size_total(sizes[(r + 1) % n_rounds])}, shard)
            state, m = finish_fn(state, summed["round"])
            total = summed["total"]
            if eval_fn is not None:
                m = {**m, **eval_fn(state, test[0], test[1])}
            ms.append(m)
        return state, _stack(ms)

    return superstep


# ---------------------------------------------------------------------------
# Row-sharded EF exchange
# ---------------------------------------------------------------------------
# A rank's EF block is always the resident scratch-row layout [N_loc+1, n]:
# row N_loc is the write sink, so table.shape[0] - 1 rows are owned.

def _owned(table, cids, shard):
    """(owned mask, first owned id, owned-row count) of ``cids``."""
    n_loc = table.shape[0] - 1
    lo = shard.position * n_loc
    return (cids >= lo) & (cids < lo + n_loc), lo, n_loc


def _rows_mask(mask, rows):
    return mask.reshape((-1,) + (1,) * (rows.dim() - 1))


def _ef_gather_contrib(table, cids, shard):
    """This rank's masked term of a round's ``[C, n]`` gather all-reduce."""
    owned, lo, n_loc = _owned(table, cids, shard)
    local_idx = torch.clamp(cids - lo, 0, n_loc - 1).to(torch.int32)
    rows = ops.ef_gather(table, local_idx)
    return torch.where(_rows_mask(owned, rows), rows, torch.zeros_like(rows))


def ef_gather_exchange(table, cids, shard):
    """The round's full ``[C, n]`` EF rows from the row-sharded blocks.

    ``table`` is this rank's block ``[N_loc+1, n]`` (its scratch row is
    never read); ``cids [C]`` the full round sample.  Each rank gathers
    the sampled rows it owns with a K6 launch on clipped ids, zeroes the
    rest, and one all-reduce gives every rank the whole matrix.  Rows have
    one owner each, so the sum is exact (a -0.0 row comes back +0.0).
    """
    return shard.all_reduce(_ef_gather_contrib(table, cids, shard))


def _ef_place_positional(new_rows, shard):
    """This rank's ``[C_loc, n]`` rows at their positional offset in a zero
    ``[C, n]`` buffer (the scatter exchange's all-reduce operand)."""
    c_loc = new_rows.shape[0]
    full = torch.zeros((c_loc * shard.n_shards,) + tuple(new_rows.shape[1:]),
                       dtype=new_rows.dtype, device=new_rows.device)
    full.narrow(0, shard.position * c_loc, c_loc).copy_(new_rows)
    return full


def _ef_scatter_local(table, cids, full, shard):
    """Scatter the all-reduced ``[C, n]`` rows this rank owns into its
    block, in place (K7), sending the rows it does not own to the scratch
    row ``N_loc``: a clipped id could alias an owned row, and K7 keeps an
    arbitrary one of several writes to one row."""
    owned, lo, n_loc = _owned(table, cids, shard)
    safe_idx = torch.where(owned, cids - lo,
                           torch.full_like(cids, n_loc)).to(torch.int32)
    return ops.ef_scatter(table, safe_idx, full.contiguous())


def ef_scatter_exchange(table, cids, new_rows, shard):
    """Write this rank's new EF rows back to their owners.

    ``new_rows [C_loc, n]`` are the residuals of this rank's POSITIONAL
    clients, whose ids any rank may own: they are placed at their offset
    in a zero ``[C, n]`` buffer, one all-reduce gives every rank the whole
    set, and each rank scatters the rows it owns into its block in place.
    """
    full = shard.all_reduce(_ef_place_positional(new_rows, shard))
    return _ef_scatter_local(table, cids, full, shard)


def _ef_gather_next_contrib(table, cids_prev, cids_next, new_rows, shard):
    """This rank's term of the NEXT round's gather all-reduce, computed
    BEFORE this round's scatter lands (the fused path's pipelining).

    For next-round position ``j`` with client ``c = cids_next[j]``:

    * ``c`` trained this round on THIS rank: its fresh row from
      ``new_rows`` (the value the scatter is about to write);
    * ``c`` trained this round on another rank: nothing (that rank has
      the fresh row);
    * ``c`` did not train this round: the owner's table row, which the
      pending scatter leaves alone.

    Ids are distinct within a round, so exactly one rank contributes each
    row and the sum equals :func:`ef_gather_exchange` on the scattered
    table.
    """
    c_loc = new_rows.shape[0]
    prev_local = cids_prev.narrow(0, shard.position * c_loc, c_loc)
    match = cids_next[:, None] == prev_local[None, :]          # [C, C_loc]
    trained_here = match.any(dim=1)
    local_pos = match.to(torch.int32).argmax(dim=1)
    from_train = new_rows.index_select(0, local_pos)
    trained_any = (cids_next[:, None] == cids_prev[None, :]).any(dim=1)
    owned, lo, n_loc = _owned(table, cids_next, shard)
    local_idx = torch.clamp(cids_next - lo, 0, n_loc - 1).to(torch.int32)
    from_table = ops.ef_gather(table, local_idx)
    return torch.where(
        _rows_mask(trained_here, from_train), from_train,
        torch.where(_rows_mask(owned & ~trained_any, from_table), from_table,
                    torch.zeros_like(from_table)))


def _slice_positional(full_rows, shard, c_loc):
    """This rank's positional ``[C_loc, n]`` block of each ``[C, n]``."""
    return [g.narrow(0, shard.position * c_loc, c_loc) for g in full_rows]


def make_compressed_superstep(bundle, fl, mode, n_rounds, uplink, downlink,
                              *, eval_fn=None, telemetry=None,
                              controller=None, shard=None, fused=False):
    """Compressed (codec-routed) K-round superstep.

    Returns ``superstep(global_state, ef_all, mirror, batches, sizes, lrs,
    cids, noise[, test_batch, test_mask], part=None, ctrl=None) ->
    (new_global_state, metrics [K], ef_all, new_mirror)``.

    ``ef_all``: per uplink leaf the federation's EF table ``[N, n]`` (or a
    chunk's page; under ``shard`` this rank's block with its scratch row),
    updated in place; None for a stateless uplink.  ``cids [K, C]`` int32
    selects each round's rows.  ``noise``: ``(down, up)`` with ``down``
    per leaf ``[K, n]`` and ``up`` per leaf ``[K, C, n]`` (this rank's
    clients under ``shard``; None for a codec without noise).
    ``telemetry`` / ``controller`` go to the round fn; with a controller,
    ``ctrl`` (its state) is required and updated in place.  ``shard`` /
    ``fused``: module docstring.
    """
    _require_shard(fused, shard)
    if fused:
        return _make_fused_compressed_superstep(
            bundle, fl, mode, n_rounds, uplink, downlink, eval_fn=eval_fn,
            telemetry=telemetry, controller=controller, shard=shard)
    round_fn = make_compressed_round_fn(bundle, fl, mode, uplink, downlink,
                                        shard=shard, telemetry=telemetry,
                                        controller=controller)

    def gather_rows(ef_all, cid, c_loc):
        if shard is None:
            return [ops.ef_gather(t, cid) for t in ef_all]
        return _slice_positional(
            [ef_gather_exchange(t, cid, shard) for t in ef_all], shard, c_loc)

    def scatter_rows(ef_all, cid, new_ef):
        for t, rows in zip(ef_all, new_ef):
            if shard is None:
                ops.ef_scatter(t, cid, rows)
            else:
                ef_scatter_exchange(t, cid, rows, shard)

    def superstep(global_state, ef_all, mirror, batches, sizes, lrs, cids,
                  noise, *test, part=None, ctrl=None):
        n_clients = sizes.shape[1]
        state, ms = global_state, []
        ctrl_state = ctrl
        for r in range(n_rounds):
            ef_round = (None if ef_all is None else
                        gather_rows(ef_all, cids[r], n_clients))
            out = round_fn(
                state, {k: v[r] for k, v in batches.items()}, sizes[r],
                lrs[r], ef_round, mirror, _round_noise(noise, r, n_clients),
                *_round_part(part, r), ctrl_state=ctrl_state)
            state, m, new_ef, mirror = out[:4]
            if controller is not None:
                ctrl_state = out[4]
            if ef_all is not None:
                scatter_rows(ef_all, cids[r], new_ef)
            if eval_fn is not None:
                m = {**m, **eval_fn(state, test[0], test[1])}
            ms.append(m)
        if controller is not None:
            for k, t in ctrl.items():
                t.copy_(ctrl_state[k])
        return state, _stack(ms), ef_all, mirror

    return superstep


def _make_fused_compressed_superstep(bundle, fl, mode, n_rounds, uplink,
                                     downlink, *, eval_fn, telemetry,
                                     controller, shard):
    """One all-reduce a round, compressed (sharded only).

    A per-chunk prologue all-reduce seeds round 0's EF rows and weight
    total; then round r's one all-reduce carries its contribution sums,
    its scatter placement, round r+1's gather terms and round r+1's
    weight total.  The last round's next-round terms are computed for
    round 0 of the chunk and dropped, which keeps every round the same.

    Participation leaves this layout as it is: masked clients are zeroed
    by the pre-weighted sizes (so the pipelined totals need nothing), a
    masked client's new EF row equals its incoming one, and the masked
    loss sums are two more lanes of the same buffer.
    """
    local_fn, finish_fn = make_compressed_round_parts(
        bundle, fl, mode, uplink, downlink, shard=shard, telemetry=telemetry,
        controller=controller)

    def superstep(global_state, ef_all, mirror, batches, sizes, lrs, cids,
                  noise, *test, part=None, ctrl=None):
        c_loc = sizes.shape[1]
        # prologue: round 0's EF rows and weight total in one all-reduce
        seed = fused_psum({
            "gather": ([] if ef_all is None else
                       [_ef_gather_contrib(t, cids[0], shard)
                        for t in ef_all]),
            "total": _size_total(sizes[0])}, shard)
        ef_rows = (None if ef_all is None else
                   _slice_positional(seed["gather"], shard, c_loc))
        total = seed["total"]
        state, ms = global_state, []
        ctrl_state = ctrl
        for r in range(n_rounds):
            nxt = (r + 1) % n_rounds
            contribs, aux = local_fn(
                state, {k: v[r] for k, v in batches.items()}, total,
                sizes[r], lrs[r], ef_rows, mirror,
                _round_noise(noise, r, c_loc), *_round_part(part, r),
                ctrl_state=ctrl_state)
            new_ef = aux["new_ef"] or []
            table = ef_all or []
            summed = fused_psum({
                "round": contribs,
                "scat": [_ef_place_positional(rows, shard)
                         for rows in new_ef],
                "gath": [_ef_gather_next_contrib(t, cids[r], cids[nxt], rows,
                                                 shard)
                         for t, rows in zip(table, new_ef)],
                "total": _size_total(sizes[nxt])}, shard)
            out = finish_fn(state, summed["round"], ctrl_state)
            state, m = out[:2]
            if controller is not None:
                ctrl_state = out[2]
            for t, full in zip(table, summed["scat"]):
                _ef_scatter_local(t, cids[r], full, shard)
            if ef_all is not None:
                ef_rows = _slice_positional(summed["gath"], shard, c_loc)
            total = summed["total"]
            mirror = aux["bcast"]
            if eval_fn is not None:
                m = {**m, **eval_fn(state, test[0], test[1])}
            ms.append(m)
        if controller is not None:
            for k, t in ctrl.items():
                t.copy_(ctrl_state[k])
        return state, _stack(ms), ef_all, mirror

    return superstep
