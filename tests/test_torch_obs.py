"""The port's observability (``repro_torch.obs``) and the engine's run-time
options (``telemetry``, ``runlog``, ``halt_on_nonfinite``,
``profile_dir``), on the CPU, against the JAX package where it has a
counterpart.

* Run log: JSONL round trip, span nesting (per thread), the disabled
  path's shared no-op span, ``as_runlog``, ``json_safe`` on tensors.
* Telemetry: the taps JAX selects; bit-invisible to the model in both
  modes, plain and compressed; its ``tele/`` values within rtol 1e-4 of
  JAX's engine, participation taps included.
* Report: JAX's ``build_report`` and the port's give the same dict on the
  same records; a port run's run log builds a report that renders.
* ``halt_on_nonfinite`` stops at JAX's round and writes the checkpoint;
  ``profile_dir`` writes a trace holding one ``superstep`` range a chunk.
"""
from __future__ import annotations

import functools
import json
import math
import os
import threading

import numpy as np
import pytest
import torch
from test_torch_control import (SEED, _bundles, _data, _fl, _jax_state,
                                _parts)
from test_torch_participation import CHAOS_KW

from repro.configs.base import FLConfig as JFL
from repro.data.federated import ChaosConfig as JChaos
from repro.data.federated import FederatedDataset as JFD
from repro.fl.server import run_federated as j_run_federated
from repro.obs import build_report as j_build_report
from repro.obs import make_telemetry as j_make_telemetry
from repro.obs import render as j_render
from repro_torch.chaos import ChaosConfig
from repro_torch.data import FederatedDataset
from repro_torch.engine.metrics import MetricsPump
from repro_torch.fl.comm import CommLog
from repro_torch.fl.server import run_federated
from repro_torch.interop import state_from_numpy
from repro_torch.obs import (NULL_RUNLOG, ClientTapCtx, NullRunLog, RunLog,
                             TelemetryTap, as_runlog, build_report,
                             json_safe, make_telemetry, register_tap,
                             registered_taps, render)
from repro_torch.obs.telemetry import _TAPS
from repro_torch.tree import tree_leaves

TELE_CASES = {
    "plain": {},
    "topk": dict(uplink_codec="topk", topk_frac=0.25),
    "deadline-topk": dict(uplink_codec="topk", topk_frac=0.25,
                          participation="deadline", over_provision=1.5),
}


def _chaos_data(cls, chaos_cls):
    parts, test = _parts()
    return cls(parts, test, seed=3, chaos=chaos_cls(**CHAOS_KW))


def _port_data(case):
    return (_chaos_data(FederatedDataset, ChaosConfig)
            if "deadline" in case else _data())


def _run(case, mode="client_parallel", **kw):
    return run_federated(_bundles()[1], _fl(**TELE_CASES[case]),
                         _port_data(case), rounds=4, seed=SEED,
                         eval_every=2, superstep_rounds=2, mode=mode,
                         device="cpu",
                         global_state=state_from_numpy(_jax_state()), **kw)


@functools.cache
def _jax_tele_run(case):
    data = (_chaos_data(JFD, JChaos) if "deadline" in case
            else _data(JFD))
    return j_run_federated(_bundles()[0], _fl(JFL, **TELE_CASES[case]),
                           data, rounds=4, seed=SEED, eval_every=2,
                           superstep_rounds=2, telemetry=True)


# --------------------------------------------------------------------------
# run log
# --------------------------------------------------------------------------

def test_runlog_jsonl_roundtrip_and_nesting(tmp_path):
    path = str(tmp_path / "log" / "run.jsonl")
    rl = RunLog(path)
    rl.event("run.start", rounds=3, arr=np.int64(7), t=torch.tensor(2.5))
    with rl.span("outer", tag="a"):
        with rl.span("inner"):
            pass
    rl.counter("queue.wait_s", np.float32(0.25))
    rl.warning("metrics.nonfinite", round=2, keys=["acc"])
    rl.close()
    recs = rl.records()
    # spans record at exit: inner closes before outer
    assert [r["kind"] for r in recs] == ["event", "span", "span",
                                        "counter", "event"]
    assert recs[0]["t"] == 2.5 and recs[0]["arr"] == 7
    inner = next(r for r in recs if r.get("name") == "inner")
    outer = next(r for r in recs if r.get("name") == "outer")
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["tag"] == "a" and inner["dur"] <= outer["dur"]
    warn = next(r for r in recs if r.get("level") == "warning")
    assert warn["name"] == "metrics.nonfinite" and warn["round"] == 2
    assert RunLog.load(path) == recs            # the streamed file
    json.dumps(recs)
    path2 = str(tmp_path / "resaved.jsonl")
    assert rl.save(path2) == path2 and RunLog.load(path2) == recs
    with pytest.raises(ValueError, match="needs a path"):
        RunLog().save()


def test_runlog_thread_local_nesting():
    rl = RunLog()
    with rl.span("main.span"):
        t = threading.Thread(target=lambda: rl.span("worker.span")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
        with rl.span("main.child"):
            pass
    recs = {r["name"]: r for r in rl.records()}
    assert recs["worker.span"]["parent"] is None
    assert recs["main.child"]["parent"] == recs["main.span"]["id"]


def test_null_runlog_and_as_runlog(tmp_path):
    assert as_runlog(None) is NULL_RUNLOG
    assert isinstance(as_runlog(NULL_RUNLOG), NullRunLog)
    s1 = NULL_RUNLOG.span("chunk.dispatch", r0=0, r1=8)
    assert s1 is NULL_RUNLOG.span("other")      # one shared span, no alloc
    with s1:
        pass
    NULL_RUNLOG.event("e")
    NULL_RUNLOG.counter("c", 1)
    NULL_RUNLOG.warning("w")
    assert NULL_RUNLOG.records() == []
    assert not NULL_RUNLOG.enabled and NULL_RUNLOG.path is None
    p = str(tmp_path / "x.jsonl")
    rl = as_runlog(p)
    assert isinstance(rl, RunLog) and rl.path == p and as_runlog(rl) is rl
    rl.event("e")
    rl.close()
    assert RunLog.load(p)[0]["name"] == "e"


def test_json_safe_tensors_and_numpy():
    assert json_safe(np.float32(1.5)) == 1.5
    assert json_safe(np.int64(3)) == 3
    assert json_safe(np.bool_(True)) == 1
    assert json_safe(torch.tensor(0.5)) == 0.5
    assert json_safe(torch.arange(3, dtype=torch.int32)) == [0, 1, 2]
    assert json_safe(np.arange(2)) == [0, 1]
    assert json_safe({"a": (np.int32(1), None)}) == {"a": [1, None]}
    assert isinstance(json_safe(object()), str)
    # the CommLog serializes through it
    from repro_torch.fl import comm
    assert comm.json_safe is json_safe


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,available,taps", [
    ("plain", (), None), ("compressed", (), None),
    ("compressed", ("ef",), None),
    ("compressed", ("ef", "pmask", "staleness", "level", "eff_bytes"),
     None),
    ("plain", ("pmask", "staleness"), ("update", "participation")),
    ("plain", (), ("ef",)),
], ids=["plain", "compressed", "ef", "all", "subset", "none"])
def test_make_telemetry_selection_matches_jax(kind, available, taps):
    t = make_telemetry(kind, n_clients=4, available=frozenset(available),
                       taps=taps)
    j = j_make_telemetry(kind, n_clients=4, available=frozenset(available),
                         taps=taps)
    assert (t is None) == (j is None)
    if t is not None:
        assert [x.name for x in t.taps] == [x.name for x in j.taps]
        assert t.round_ctx.n_clients == 4
    with pytest.raises(KeyError):
        make_telemetry("plain", taps=("nonsense",))
    with pytest.raises(ValueError, match="kind"):
        make_telemetry("sideways")


def test_register_tap_plugin_rides_engine():
    class NexTap(TelemetryTap):
        name = "nexsum_torch"
        kinds = ("plain",)
        requires = ("n_examples",)

        def client_sums(self, ctx):
            return {"sum": ctx.n_examples}

        def finish(self, summed, ctx):
            return {"nex_sum": summed["nexsum_torch.sum"]}

    register_tap(NexTap())
    try:
        assert "nexsum_torch" in registered_taps()
        t = make_telemetry("plain", n_clients=2, taps=("nexsum_torch",))
        assert set(t.client_sums(ClientTapCtx(
            n_examples=torch.tensor(3.0)))) == {"nexsum_torch.sum"}
        res = _run("plain", telemetry=("nexsum_torch",))
        assert all(h["tele/nex_sum"] == 4 * 12 for h in res.comm.history)
        assert not any("tele/update_norm" in h for h in res.comm.history)
    finally:
        _TAPS.pop("nexsum_torch", None)
    with pytest.raises(ValueError, match="non-default name"):
        register_tap(TelemetryTap())


@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
@pytest.mark.parametrize("case", ["plain", "topk"])
def test_telemetry_bit_invisible(case, mode):
    """Telemetry on: the same model and history, bit for bit, plus the
    ``tele/`` keys."""
    off = _run(case, mode)
    on = _run(case, mode, telemetry=True)
    assert on.stats["telemetry"] and not off.stats["telemetry"]
    for a, b in zip(tree_leaves(off.global_state),
                    tree_leaves(on.global_state)):
        assert torch.equal(a, b)
    for ho, hn in zip(off.comm.history, on.comm.history):
        assert {k: v for k, v in hn.items()
                if not k.startswith("tele/")} == ho
        assert any(k.startswith("tele/") for k in hn)


@pytest.mark.parametrize("case", sorted(TELE_CASES))
def test_telemetry_matches_jax(case):
    """Every ``tele/`` value of every round within rtol 1e-4 of JAX's
    engine (the participation taps exactly: they count clients)."""
    jres = _jax_tele_run(case)
    tres = _run(case, telemetry=True)
    keys = {k for h in jres.comm.history for k in h if k.startswith("tele/")}
    assert keys == {k for h in tres.comm.history for k in h
                    if k.startswith("tele/")}
    want = {"plain": {"tele/update_norm"},
            "topk": {"tele/ef_delta_ratio", "tele/compress_err"},
            "deadline-topk": {"tele/effective_cohort",
                              "tele/mean_staleness",
                              "tele/dropped_clients"}}[case]
    assert want <= keys
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        for k in keys:
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
        for k in ("tele/effective_cohort", "tele/dropped_clients",
                  "tele/clients", "tele/weight_total"):
            if k in hj:
                assert ht[k] == hj[k], k


# --------------------------------------------------------------------------
# metrics pump, CommLog, report
# --------------------------------------------------------------------------

def _comm():
    return CommLog().bind_sizes({"model": {"w": torch.zeros(4)}})


def test_metrics_pump_nonfinite_warning_and_schedule():
    comm, rl = _comm(), RunLog()
    schedule = {"bytes": [8.0, 16.0],
                "effective": [{"level": 0, "eff_topk_frac": 0.5},
                              {"level": 1, "eff_topk_frac": 1.0}]}
    with MetricsPump(comm, 2, runlog=rl, schedule=schedule,
                     wire_up=16) as pump:
        pump.submit({"local_loss": torch.tensor([1.0, float("nan")]),
                     "aux": torch.tensor([float("inf"), 2.0]),
                     "tele/level": torch.tensor([1.0, 0.0])})
        pump.drain()
        assert pump.nonfinite_round == 1
    warns = [r for r in rl.records() if r.get("level") == "warning"]
    assert [(w["round"], w["keys"]) for w in warns] == \
        [(1, ["aux"]), (2, ["local_loss"])]
    assert math.isnan(comm.history[1]["local_loss"])   # value untouched
    h0, h1 = comm.history
    assert (h0["level"], h0["eff_topk_frac"], h0["bytes_up"]) == (1, 1.0, 32)
    assert (h1["level"], h1["eff_topk_frac"], h1["bytes_up"]) == (0, 0.5, 16)


def test_commlog_effective_fields_and_records(tmp_path):
    comm = _comm()
    comm.log_round(None, 2, {"acc": np.float32(0.5)}, wire_up=8,
                   effective={"level": 0, "eff_quant_bits": 4})
    comm.log_round(None, 2, {"acc": torch.tensor(0.75)})
    recs = comm.to_records()
    json.dumps(recs)
    assert recs[0]["level"] == 0 and recs[0]["eff_quant_bits"] == 4
    assert recs[0]["bytes_up"] == 16 and "level" not in recs[1]
    assert recs[1]["acc"] == 0.75
    assert recs[-1] == {"kind": "summary", "schema": 2, "rounds": 2,
                        "bytes_up": comm.bytes_up,
                        "bytes_down": comm.bytes_down}
    path = comm.save(str(tmp_path / "comm.jsonl"))
    with open(path) as f:
        assert [json.loads(line) for line in f] == recs


def test_report_from_engine_run_equals_jax_report(tmp_path):
    """A run log of a port engine run (telemetry, a controller, the paged
    EF store, checkpoints) builds a report with every section, the same
    dict JAX's ``build_report`` makes of the same records, and renders."""
    path = str(tmp_path / "run.jsonl")
    fl = _fl(uplink_codec="topk", topk_frac=0.25, controller="loss_trend")
    res = run_federated(_bundles()[1], fl, _data(), rounds=6, seed=SEED,
                        eval_every=2, superstep_rounds=2, device="cpu",
                        telemetry=True, runlog=path, ef_store="host",
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2)
    assert res.stats["runlog"] == path
    recs, comm = RunLog.load(path), res.comm.to_records()
    report = build_report(recs, comm)
    assert report == j_build_report(recs, comm)
    assert render(report) == j_render(report)
    rt = report["round_time"]
    assert rt["chunks"] == 3 and rt["compiles"] == 1
    assert rt["wall_s"] > 0 and rt["checkpoint_s"] > 0
    spans = report["spans"]
    assert spans["chunk.dispatch"]["count"] == 3
    assert spans["eval.dispatch"]["count"] == 3
    assert spans["prefetch.stage"]["count"] == 3
    assert spans["checkpoint.save"]["count"] == 4       # 3 + the final
    assert spans["ef.page.gather"]["count"] == 3
    assert report["ef_page"]["writeback_count"] == 3
    assert report["bytes"]["rounds"] == 6
    assert report["schedule"]["rounds"] == 6
    assert "tele/ef_delta_ratio" in report["telemetry"]
    names = [r["name"] for r in recs if r["kind"] == "event"]
    assert names[0] == "run.start" and names[-1] == "run.end"
    text = render(report)
    assert "round-time breakdown" in text and "compression schedule" in text
    assert build_report(None, None) == {} and render({}) == "(empty report)"


# --------------------------------------------------------------------------
# halt_on_nonfinite, profile_dir
# --------------------------------------------------------------------------

def _poisoned(cls):
    """The data with a NaN row in each of client 5's images: the first
    round that samples client 5 trains to a NaN loss."""
    parts, test = _parts()
    parts = [dict(p) for p in parts]
    x = np.array(parts[5]["x"], copy=True)
    x[:, 0] = np.nan
    parts[5]["x"] = x
    return cls(parts, test, seed=3)


def test_halt_on_nonfinite_matches_jax(tmp_path):
    kw = dict(rounds=8, seed=SEED, eval_every=2, superstep_rounds=2)
    jres = j_run_federated(_bundles()[0], _fl(JFL), _poisoned(JFD),
                           halt_on_nonfinite=True, **kw)
    d = str(tmp_path / "ck")
    rl = RunLog()
    tres = run_federated(_bundles()[1], _fl(), _poisoned(FederatedDataset),
                         device="cpu", halt_on_nonfinite=True,
                         checkpoint_dir=d, runlog=rl,
                         global_state=state_from_numpy(_jax_state()), **kw)
    assert jres.stats["halted_at"] is not None
    assert tres.stats["halted_at"] == jres.stats["halted_at"] < 8
    assert len(tres.comm.history) == len(jres.comm.history) \
        == tres.stats["halted_at"]
    bad = [i + 1 for i, h in enumerate(tres.comm.history)
           if not all(math.isfinite(v) for v in h.values())]
    assert bad and bad[0] > tres.stats["halted_at"] - 2   # its chunk's
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["halted"] is True and meta["round"] == tres.stats["halted_at"]
    halt = [r for r in rl.records() if r.get("name") == "run.halt"]
    assert len(halt) == 1 and halt[0]["round"] == bad[0]
    # the same run without the flag goes on to the end
    free = run_federated(_bundles()[1], _fl(), _poisoned(FederatedDataset),
                         device="cpu", **kw)
    assert free.stats["halted_at"] is None and len(free.comm.history) == 8


def test_profile_dir_writes_a_trace_with_superstep_ranges(tmp_path):
    res = _run("topk", profile_dir=str(tmp_path / "prof"))
    path = res.stats["profile"]
    assert path and os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "superstep"
               and e.get("cat") == "user_annotation" for e in events) \
        == res.stats["chunks"] == 2
    # profiling reads the run; it does not change it
    plain = _run("topk")
    assert plain.comm.history == res.comm.history
    for a, b in zip(tree_leaves(plain.global_state),
                    tree_leaves(res.global_state)):
        assert torch.equal(a, b)
