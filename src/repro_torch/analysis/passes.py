"""Built-in lowered-superstep invariant passes (port of
``repro/analysis/passes.py``).

Each pass inspects one :class:`repro_torch.analysis.lower.LoweredSuperstep`
(a config point recorded at K and K + 1 rounds) and returns findings.
The expectations they pin are the engine's structural contracts:

* ``collectives``: a fused sharded chunk issues exactly ONE all-reduce a
  round and one outside the rounds (the prologue), K + 1 a chunk; the
  unfused oracle at least three a round and none outside; an unsharded
  chunk none at all; and nothing but all-reduces anywhere, every one of
  them counted by the :class:`ClientSharding`;
* ``host-sync``: no op that makes the host wait for the device anywhere
  in the chunk (``.item()``, ``nonzero``, a device-to-host copy), and on
  the card no capture the card refused: one host sync per CHUNK is the
  engine's whole performance story;
* ``dtype``: no float64 (or complex128) tensor in or out of any op, and
  every all-reduce operand exactly float32: a silent promotion through a
  codec would double wire bytes and break the bytes model quietly;
* ``donation``: every buffer the engine carries (global state, EF table
  or page, broadcast mirror, controller state) is updated in place: it
  keeps its address, its version advances over the run, and no op copies
  an EF leaf into a tensor the engine does not carry (the hidden copy of
  the EF page); on the card the captured graph's pointer check passes.  JAX
  checks buffer aliasing in the compiled executable; the port's carried
  tensors are already this rank's blocks, so JAX's per-argument
  sharding tables have no counterpart;
* ``collective-bytes``: the codec wire model the CommLog charges stays
  consistent (compressed <= ideal f32 bytes, ladder ascending with its
  top rung at the static wire bytes), and on sharded points the record's
  all-reduce bytes equal the :class:`ClientSharding`'s own count.
"""
from __future__ import annotations

from collections import Counter
from typing import List

from repro_torch.analysis.records import (ALL_REDUCE, collect_avals,
                                          collective_execution_model,
                                          count_collectives, is_host_sync,
                                          per_round)
from repro_torch.analysis.registry import AnalysisPass, Finding, register_pass

# ops that allocate a tensor: one made from an EF leaf is a hidden copy
_ALLOCATING = frozenset(("aten.empty_like", "aten.clone", "aten._to_copy",
                         "aten.new_empty", "aten.new_empty_strided"))


def _copies_ef(e, ef, carried) -> bool:
    """Whether ``e`` allocates a tensor from an EF leaf (a clone, a copy,
    an ``empty_like``), or copies an EF leaf into a buffer the engine does
    not carry."""
    if not ef:
        return False
    src = [t.storage for n, t in e.inputs if n in ("self", "src")]
    if e.name in _ALLOCATING:
        return any(s in ef for s in src[:1])
    if e.name == "aten.copy_":
        dst, srcs = e.arg("self"), e.arg("src")
        return bool(srcs and srcs[0].storage in ef and dst
                    and dst[0].storage not in carried)
    return False


@register_pass
class CollectivesPass(AnalysisPass):
    name = "collectives"
    scope = "lowered"
    description = ("exactly one all-reduce per fused round (K + 1 per "
                   "chunk), >= 3 a round for the unfused oracle, 0 "
                   "unsharded; all-reduce is the only collective")

    def run(self, low) -> List[Finding]:
        out = []
        spec = low.spec
        total = count_collectives(low.record)
        ars = count_collectives(low.record, (ALL_REDUCE,))
        if total != ars:
            out.append(self.finding(
                low.point, f"{total - ars} non-all-reduce collective(s) in "
                f"the chunk; the all-reduce is the only collective the "
                f"engine may issue"))
        if not spec.sharded:
            if total:
                out.append(self.finding(
                    low.point, f"unsharded chunk issued {total} "
                    f"collective(s); a 1-shard program must have none"))
            return out
        K = low.n_rounds
        each, outside = per_round(
            ars, count_collectives(low.record_next, (ALL_REDUCE,)), K)
        if spec.fused:
            if each != 1:
                out.append(self.finding(
                    low.point, f"fused round issues {each} all-reduces, "
                    f"invariant is exactly 1 (the packed buffer)"))
            if outside != 1:
                out.append(self.finding(
                    low.point, f"fused chunk issues {outside} all-reduce(s) "
                    f"outside its rounds, invariant is exactly 1 (the "
                    f"prologue): {ars} in a {K}-round chunk, not {K + 1}"))
        else:
            if each < 3:
                out.append(self.finding(
                    low.point, f"unfused round issues {each} all-reduces; "
                    f"the three-collective oracle layout expects >= 3"))
            if outside != 0:
                out.append(self.finding(
                    low.point, f"unfused chunk issues {outside} "
                    f"all-reduce(s) outside its rounds; the oracle layout "
                    f"keeps every exchange inside the round"))
        shard_count = low.lowerings[0].collectives
        if ars != shard_count:
            out.append(self.finding(
                low.point, f"the record holds {ars} all-reduces, the "
                f"ClientSharding counted {shard_count}"))
        return out


@register_pass
class HostSyncPass(AnalysisPass):
    name = "host-sync"
    scope = "lowered"
    needs_capture = True
    description = ("no .item() / nonzero / device-to-host copy anywhere in "
                   "the chunk; on the card no refused capture")

    def run(self, low) -> List[Finding]:
        out = []
        syncs = Counter(e.name for e in low.record if is_host_sync(e))
        for name, n in sorted(syncs.items()):
            out.append(self.finding(
                low.point, f"{n} host-synchronizing op(s) {name!r} in the "
                f"chunk; the engine syncs with the host once per chunk, "
                f"never inside it"))
        for lw in low.lowerings:
            if lw.capture_error:
                out.append(self.finding(
                    low.point, f"the card refused to capture the "
                    f"{lw.n_rounds}-round chunk: {lw.capture_error}"))
        return out


@register_pass
class DtypePass(AnalysisPass):
    name = "dtype"
    scope = "lowered"
    description = ("no float64/complex128 tensor anywhere in the chunk; "
                   "all-reduce operands are exactly float32")

    def run(self, low) -> List[Finding]:
        out = []
        seen64 = Counter(t.dtype for t in collect_avals(low.record)
                         if t.dtype in ("float64", "complex128"))
        for dt, n in sorted(seen64.items()):
            out.append(self.finding(
                low.point, f"{n} {dt} tensor(s) in the chunk: silent "
                f"promotion (the engine is float32 end to end)"))
        for e in low.record:
            if e.collective is None:
                continue
            for t in e.payload:
                if t.dtype != "float32":
                    out.append(self.finding(
                        low.point, f"collective {e.name!r} carries a "
                        f"{t.dtype} operand; the packed wire buffer must "
                        f"stay float32"))
        return out


@register_pass
class DonationPass(AnalysisPass):
    name = "donation"
    scope = "lowered"
    needs_capture = True
    description = ("every carried buffer (state, EF table/page, mirror, "
                   "controller state) is updated in place: same address, "
                   "version advanced, no hidden copy of an EF leaf")

    def run(self, low) -> List[Finding]:
        out = []
        lw = low.lowerings[0]
        if lw.capture_error:
            return out            # nothing ran to the end: host-sync says why
        moved = [c for c in lw.carried if c[1] != c[2]]
        if moved:
            out.append(self.finding(
                low.point, f"{len(moved)} carried buffer(s) changed address "
                f"over the chunk (first {moved[0][0]}): the state was "
                f"rebound, not written in place"))
        stale = [c for c in lw.carried if c[4] <= c[3]]
        if stale:
            out.append(self.finding(
                low.point, f"{len(stale)} of {len(lw.carried)} carried "
                f"buffer(s) were not written in place (first "
                f"{stale[0][0]}): an update was rebound or copied "
                f"elsewhere, so the next chunk reads stale state"))
        copies = Counter(e.name for e in low.record
                         if _copies_ef(e, lw.ef_storages,
                                       lw.carried_storages))
        for name, n in sorted(copies.items()):
            out.append(self.finding(
                low.point, f"{n} {name!r} op(s) copy an EF leaf into a new "
                f"tensor: a hidden copy of the EF table/page"))
        for w in low.lowerings:
            if w.replay_error:
                out.append(self.finding(
                    low.point, f"graph replay refused: {w.replay_error}"))
        return out


@register_pass
class CollectiveBytesPass(AnalysisPass):
    name = "collective-bytes"
    scope = "lowered"
    description = ("record all-reduce bytes == the ClientSharding's count, "
                   "every collective through it; codec wire model "
                   "consistent (compressed <= ideal, ladder monotone)")

    def run(self, low) -> List[Finding]:
        out = []
        spec = low.spec
        # wire-model audit runs everywhere (it needs no device program)
        ideal = low.ideal_model_bytes
        if low.uplink is not None:
            if low.wire_up > ideal:
                out.append(self.finding(
                    low.point, f"uplink codec charges {low.wire_up} wire "
                    f"bytes, above the ideal f32 model ({ideal}) — the "
                    f"compression accounting is inverted"))
            if low.wire_down is not None and low.wire_down > ideal:
                out.append(self.finding(
                    low.point, f"downlink codec charges {low.wire_down} > "
                    f"ideal {ideal} wire bytes"))
        if low.level_bytes is not None:
            lv = low.level_bytes
            if list(lv) != sorted(lv):
                out.append(self.finding(
                    low.point, f"ladder level_bytes {lv} not ascending"))
            if lv and low.wire_up is not None and lv[-1] != low.wire_up:
                out.append(self.finding(
                    low.point, f"ladder top rung charges {lv[-1]} bytes, "
                    f"static wire model charges {low.wire_up} — the "
                    f"capacity rung must BE the configured codec"))
        if not spec.sharded:
            return out
        lw = low.lowerings[0]
        ops, nbytes = collective_execution_model(low.record, (ALL_REDUCE,))
        if nbytes != lw.collective_bytes:
            out.append(self.finding(
                low.point, f"the record's all-reduces carry {nbytes} B, the "
                f"ClientSharding counted {lw.collective_bytes} B: traffic "
                f"the bytes model does not account for"))
        all_ops = collective_execution_model(low.record)[0]
        if all_ops != lw.collectives:
            out.append(self.finding(
                low.point, f"{all_ops} collective payload(s) in the record, "
                f"{lw.collectives} through the ClientSharding: a collective "
                f"bypassed the client split's accounting"))
        return out
