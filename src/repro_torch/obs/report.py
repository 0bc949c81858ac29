"""Run reports (port of ``repro/obs/report.py``): RunLog + CommLog records
-> where the round time went.

:func:`build_report` folds a run's two record streams —

* the :class:`repro_torch.obs.runlog.RunLog` JSONL (spans, events and
  counters the engine emits: chunk dispatch, eval dispatch, checkpoint
  saves, prefetch staging, EF page gathers and write-backs, queue waits),
  and
* the :meth:`repro_torch.fl.comm.CommLog.to_records` per-round history
  (bytes and metrics, ``tele/`` telemetry included)

— into one plain dict: a round-time breakdown (dispatch vs metrics-drain
vs prefetch-stall vs eval vs checkpoint, each as seconds and a fraction
of the run's wall time), bytes/round, warning events, the adaptive
controller's realized schedule, and first/last/mean trends for every
telemetry series.  :func:`render` pretty-prints it.

Only the standard library here: a report can be built wherever the JSONL
can be read.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

__all__ = ["span_totals", "round_time_breakdown", "telemetry_summary",
           "bytes_per_round", "ef_page_summary", "schedule_summary",
           "build_report", "render"]

# span names charged to the dispatch thread's wall clock, in report order
# (ef.page.writeback is NOT here: it runs on the lane's worker thread and
# only costs the dispatch thread via the ef.page.stall_s counter)
_BREAKDOWN_SPANS = ("chunk.dispatch", "eval.dispatch", "checkpoint.save",
                    "ef.page.gather")


def span_totals(records: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-span-name totals: count, total seconds, max seconds."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        t = out.setdefault(r["name"], {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
        t["count"] += 1
        t["total_s"] += r.get("dur", 0.0)
        t["max_s"] = max(t["max_s"], r.get("dur", 0.0))
    for t in out.values():
        t["total_s"] = round(t["total_s"], 4)
        t["max_s"] = round(t["max_s"], 4)
    return out


def _counter_last(records: List[Dict], name: str) -> Optional[float]:
    val = None
    for r in records:
        if r.get("kind") == "counter" and r.get("name") == name:
            val = r.get("value")
    return val


def _wall_s(records: List[Dict]) -> Optional[float]:
    """run.start -> run.end wall time; falls back to the record span."""
    t0 = t1 = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "run.start":
            t0 = r.get("t")
        if r.get("kind") == "event" and r.get("name") == "run.end":
            t1 = r.get("t")
    if t0 is not None and t1 is not None:
        return t1 - t0
    ts = [r.get("t", r.get("t0")) for r in records
          if r.get("t", r.get("t0")) is not None]
    return (max(ts) - min(ts)) if ts else None


def round_time_breakdown(records: List[Dict]) -> Dict[str, Any]:
    """Where the dispatch thread's wall time went, from one run's records.

    ``dispatch`` / ``eval`` / ``checkpoint`` come from their spans;
    ``metrics_drain`` and ``prefetch_stall`` from the engine's end-of-run
    counters (``metrics.wait_s`` / ``prefetch.wait_s``); ``other`` is the
    wall-time remainder — on a healthy run, mostly the time the host sat
    idle while superstep chunks trained on device.
    """
    spans = span_totals(records)
    wall = _wall_s(records)
    parts = {
        "dispatch_s": spans.get("chunk.dispatch", {}).get("total_s", 0.0),
        "eval_s": spans.get("eval.dispatch", {}).get("total_s", 0.0),
        "checkpoint_s": spans.get("checkpoint.save", {}).get("total_s", 0.0),
        "ef_gather_s": spans.get("ef.page.gather", {}).get("total_s", 0.0),
        "ef_stall_s": _counter_last(records, "ef.page.stall_s") or 0.0,
        "metrics_drain_s": _counter_last(records, "metrics.wait_s") or 0.0,
        "prefetch_stall_s": _counter_last(records, "prefetch.wait_s") or 0.0,
    }
    out: Dict[str, Any] = {"wall_s": round(wall, 4) if wall else None,
                           **{k: round(v, 4) for k, v in parts.items()}}
    if wall and wall > 0:
        accounted = sum(parts.values())
        out["other_s"] = round(max(wall - accounted, 0.0), 4)
        out["fractions"] = {
            k[:-2]: round(v / wall, 4) for k, v in parts.items()}
    chunks = spans.get("chunk.dispatch", {})
    if chunks.get("count"):
        out["chunks"] = int(chunks["count"])
        out["compiles"] = sum(
            1 for r in records if r.get("kind") == "span"
            and r["name"] == "chunk.dispatch" and r.get("compile"))
    return out


def ef_page_summary(records: List[Dict]) -> Dict[str, Any]:
    """Cohort-paged EF store accounting (empty when the run was dense).

    Folds the pager's end-of-run counters (page hit/miss rows, rows
    written back, rows patched on device) with its two span families:
    ``ef.page.gather`` runs on the dispatch thread (charged to the round
    loop), ``ef.page.writeback`` on the lane's worker thread (overlapped
    — only its ``stall_s`` share blocks dispatch).
    """
    out: Dict[str, Any] = {}
    for name in ("hits", "misses", "writeback_rows", "patched_rows"):
        v = _counter_last(records, f"ef.page.{name}")
        if v is not None:
            out[name] = int(v)
    stall = _counter_last(records, "ef.page.stall_s")
    if stall is not None:
        out["stall_s"] = round(float(stall), 4)
    spans = span_totals(records)
    for key, span in (("gather", "ef.page.gather"),
                      ("writeback", "ef.page.writeback")):
        if span in spans:
            out[f"{key}_s"] = spans[span]["total_s"]
            out[f"{key}_count"] = int(spans[span]["count"])
    rows = out.get("hits", 0) + out.get("misses", 0)
    if rows:
        out["hit_rate"] = round(out.get("hits", 0) / rows, 4)
    return out


def telemetry_summary(comm_records: List[Dict],
                      prefix: str = "tele/") -> Dict[str, Dict]:
    """First/last/mean/max trend per telemetry series in the history."""
    series: Dict[str, List[float]] = {}
    for rec in comm_records:
        for k, v in rec.items():
            if k.startswith(prefix) and isinstance(v, (int, float)) \
                    and math.isfinite(v):
                series.setdefault(k, []).append(float(v))
    return {k: {"first": round(vs[0], 6), "last": round(vs[-1], 6),
                "mean": round(sum(vs) / len(vs), 6),
                "max": round(max(vs), 6), "rounds": len(vs)}
            for k, vs in series.items() if vs}


def schedule_summary(comm_records: List[Dict]) -> Dict[str, Any]:
    """The adaptive-compression controller's realized schedule, from the
    per-round effective fields (``level`` + ``eff_topk_frac`` /
    ``eff_quant_bits`` — CommLog record schema v2).  Empty for static
    runs, whose records carry no ``level``."""
    levels = [(r.get("round", i + 1), int(r["level"]))
              for i, r in enumerate(comm_records) if "level" in r]
    if not levels:
        return {}
    counts: Dict[int, int] = {}
    for _, lvl in levels:
        counts[lvl] = counts.get(lvl, 0) + 1
    switches = [{"round": rd, "level": lvl}
                for i, (rd, lvl) in enumerate(levels)
                if i == 0 or lvl != levels[i - 1][1]]
    eff_keys = ("eff_topk_frac", "eff_quant_bits")
    per_level: Dict[int, Dict] = {}
    for r in comm_records:
        if "level" in r:
            per_level.setdefault(int(r["level"]), {
                k: r[k] for k in eff_keys if k in r})
    return {"rounds": len(levels),
            "level_rounds": {str(k): v for k, v in sorted(counts.items())},
            "levels": {str(k): v for k, v in sorted(per_level.items())},
            "switches": switches[:50]}


def bytes_per_round(comm_records: List[Dict]) -> Dict[str, Any]:
    """Wire accounting across the run (the paper's x-axis)."""
    if not comm_records:
        return {}
    up = [r.get("bytes_up", 0) for r in comm_records]
    down = [r.get("bytes_down", 0) for r in comm_records]
    ideal = [r.get("bytes_up_ideal", 0) for r in comm_records]
    out = {"rounds": len(comm_records),
           "bytes_up_per_round": round(sum(up) / len(up), 1),
           "bytes_down_per_round": round(sum(down) / len(down), 1),
           "total_mb_up": round(sum(up) / 1e6, 3),
           "total_mb_down": round(sum(down) / 1e6, 3)}
    if sum(up) and sum(ideal):
        out["uplink_compression"] = round(sum(ideal) / sum(up), 2)
    return out


def build_report(runlog_records: Optional[List[Dict]] = None,
                 comm_records: Optional[List[Dict]] = None) -> Dict:
    """Fold the two record streams into one report dict (either may be
    None/empty — the report carries whatever the run collected)."""
    report: Dict[str, Any] = {}
    if runlog_records:
        report["round_time"] = round_time_breakdown(runlog_records)
        report["spans"] = span_totals(runlog_records)
        ef = ef_page_summary(runlog_records)
        if ef:
            report["ef_page"] = ef
        warns = [r for r in runlog_records
                 if r.get("kind") == "event" and r.get("level") == "warning"]
        if warns:
            report["warnings"] = warns
    if comm_records:
        # accept CommLog.to_records() verbatim: keep only round records
        # (raw history dicts carry no "kind" and pass through)
        comm_records = [r for r in comm_records
                        if r.get("kind", "round") == "round"]
    if comm_records:
        report["bytes"] = bytes_per_round(comm_records)
        tele = telemetry_summary(comm_records)
        if tele:
            report["telemetry"] = tele
        sched = schedule_summary(comm_records)
        if sched:
            report["schedule"] = sched
    return report


def render(report: Dict) -> str:
    """Report dict -> a terminal-friendly text block."""
    lines: List[str] = []
    rt = report.get("round_time")
    if rt:
        lines.append("== round-time breakdown ==")
        wall = rt.get("wall_s")
        lines.append(f"wall: {wall}s  chunks: {rt.get('chunks', '?')} "
                     f"(compiled {rt.get('compiles', '?')})")
        for k in ("dispatch_s", "eval_s", "checkpoint_s", "ef_gather_s",
                  "ef_stall_s", "metrics_drain_s", "prefetch_stall_s",
                  "other_s"):
            if k in rt:
                frac = (report["round_time"].get("fractions", {})
                        .get(k[:-2]))
                pct = f"  ({frac * 100:.1f}%)" if frac is not None else ""
                lines.append(f"  {k[:-2]:>15s}: {rt[k]:9.4f}s{pct}")
    ef = report.get("ef_page")
    if ef:
        lines.append("== ef page store ==")
        rows = ef.get("hits", 0) + ef.get("misses", 0)
        hr = f"  hit rate {ef['hit_rate'] * 100:.1f}%" \
            if "hit_rate" in ef else ""
        lines.append(f"  rows gathered: {rows} "
                     f"(hits {ef.get('hits', 0)}, "
                     f"misses {ef.get('misses', 0)}){hr}")
        lines.append(f"  written back: {ef.get('writeback_rows', 0)} rows "
                     f"in {ef.get('writeback_count', 0)} flushes "
                     f"({ef.get('writeback_s', 0.0):.4f}s worker-thread)")
        lines.append(f"  device-patched: {ef.get('patched_rows', 0)} rows  "
                     f"gather {ef.get('gather_s', 0.0):.4f}s  "
                     f"dispatch stall {ef.get('stall_s', 0.0):.4f}s")
    b = report.get("bytes")
    if b:
        lines.append("== bytes ==")
        lines.append(
            f"  up {b.get('bytes_up_per_round', 0):.0f} B/round "
            f"({b.get('total_mb_up', 0)} MB total), "
            f"down {b.get('bytes_down_per_round', 0):.0f} B/round"
            + (f", uplink compression {b['uplink_compression']}x"
               if "uplink_compression" in b else ""))
    tele = report.get("telemetry")
    if tele:
        lines.append("== telemetry trends ==")
        for k in sorted(tele):
            t = tele[k]
            lines.append(f"  {k:>24s}: first={t['first']:.5g} "
                         f"last={t['last']:.5g} mean={t['mean']:.5g}")
    sched = report.get("schedule")
    if sched:
        lines.append("== compression schedule ==")
        lines.append("  rounds/level: " + "  ".join(
            f"L{k}:{v}" for k, v in sched["level_rounds"].items()))
        sw = sched.get("switches", [])
        lines.append("  switches: " + (" -> ".join(
            f"r{s['round']}=L{s['level']}" for s in sw) if sw else "none"))
    warns = report.get("warnings")
    if warns:
        lines.append(f"== warnings ({len(warns)}) ==")
        for w in warns[:20]:
            lines.append(f"  {w.get('name')}: "
                         + " ".join(f"{k}={v}" for k, v in w.items()
                                    if k not in ("kind", "name", "t",
                                                 "level")))
    return "\n".join(lines) if lines else "(empty report)"
