"""The port's engine (``repro_torch.engine``) on the CPU: against the port's
own reference loop (exactly: the same draws, learning rates, offsets and
per-round math, so the final model and the ``CommLog`` history are
equal), against the JAX package's reference loop (rtol 1e-4 / atol 1e-5,
the tolerance of slice 1's parity tests, and identical bytes), and
against the JAX engine's schedule, sampling and checkpoint layout.

On the CPU the engine runs each chunk's superstep eagerly; on the card
the same superstep is replayed from a captured CUDA graph
(``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_rounds import NARROW, _check, _data

from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.engine.engine import chunk_schedule as j_chunk_schedule
from repro.fl.server import run_federated_reference as j_ref
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import CNN_MNIST as T_MNIST
from repro_torch.configs import FLConfig as TFL
from repro_torch.data import FederatedDataset as TFD
from repro_torch.engine import (MetricsPump, StagingPool, chunk_schedule,
                                run_federated_engine)
from repro_torch.engine.engine import _auto_chunk_rounds
from repro_torch.fl.api import FederatedTrainer, RunOptions
from repro_torch.fl.comm import CommLog
from repro_torch.fl.server import (make_noise_source, run_federated,
                                   run_federated_reference)
from repro_torch.interop import state_from_numpy
from repro_torch.models import make_bundle
from repro_torch.obs import RunLog
from repro_torch.tree import tree_leaves

N_CLIENTS, N_TEST, ROUNDS, SEED = 4, 40, 5, 1
BASE = dict(clients_per_round=2, local_steps=2, local_batch=8, lr=0.05)
CASES = {
    "plain": dict(algorithm="fedavg"),
    "topk": dict(algorithm="fedavg", uplink_codec="topk", topk_frac=1 / 16),
    "int8-downtopk": dict(algorithm="fedavg", uplink_codec="int8",
                          downlink_codec="topk", topk_frac=1 / 16),
    "fusion-topk": dict(algorithm="fedfusion", fusion_op="conv",
                        uplink_codec="topk", topk_frac=1 / 16),
}
MODES = ["client_parallel", "client_sequential"]


@functools.cache
def _bundle():
    return make_bundle(dataclasses.replace(T_MNIST, **NARROW))


@functools.cache
def _parts():
    return _data(NARROW["input_shape"], N_CLIENTS, N_TEST)


def _tdata(seed=0):
    parts, test = _parts()
    return TFD(parts, test, seed=seed)


def _fl(case, **kw):
    return TFL(**{**BASE, **CASES[case], **kw})


def _engine(case, mode="client_parallel", *, data=None, rounds=ROUNDS,
            fl_kw=None, **kw):
    return run_federated(_bundle(), _fl(case, **(fl_kw or {})),
                         data or _tdata(), rounds=rounds, seed=SEED,
                         mode=mode, eval_examples=64, device="cpu", **kw)


@functools.cache
def _reference(case, mode):
    return run_federated_reference(_bundle(), _fl(case), _tdata(),
                                   rounds=ROUNDS, seed=SEED, mode=mode,
                                   eval_examples=64, device="cpu")


def _assert_same(a, b):
    for x, y in zip(tree_leaves(a.global_state), tree_leaves(b.global_state)):
        assert torch.equal(x, y), (x - y).abs().max().item()
    assert a.comm.history == b.comm.history
    assert (a.comm.bytes_up, a.comm.bytes_down) == (b.comm.bytes_up,
                                                    b.comm.bytes_down)


# --------------------------------------------------------------------------
# the engine against the port's reference loop: exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_equals_port_reference(case, mode, chunk):
    eng = _engine(case, mode, superstep_rounds=chunk)
    _assert_same(eng, _reference(case, mode))
    assert eng.stats["chunks"] == -(-ROUNDS // chunk)
    assert eng.stats["eval_in_chunk"] and not eng.stats["cuda_graphs"]
    assert eng.stats["ef_store"] == (None if case == "plain" else "device")


@pytest.mark.parametrize("kw", [dict(prefetch=False),
                                dict(superstep_rounds="auto"),
                                dict(eval_every=2, superstep_rounds=1)],
                         ids=["prefetch-off", "auto-chunk", "no-overlap"])
def test_engine_knobs_leave_results_unchanged(kw):
    base = _engine("topk", superstep_rounds=4,
                   eval_every=kw.get("eval_every", 1))
    other = _engine("topk", **{"superstep_rounds": 4, **kw})
    _assert_same(base, other)
    if kw.get("superstep_rounds") == "auto":
        assert 8 <= other.stats["chunk_rounds"] <= 256
        assert other.stats["calibration_s"] > 0
        assert base.stats["calibration_s"] is None
    if "eval_every" in kw:
        # eval rounds cut the chunks; the boundary eval reads the live
        # state (no snapshot) and equals the reference loop's eval
        assert base.stats["chunks"] == 3 and other.stats["chunks"] == ROUNDS
        assert not base.stats["eval_in_chunk"]
        assert [("acc" in h) for h in base.comm.history] == \
            [False, True, False, True, False]
        _assert_same(base, run_federated_reference(
            _bundle(), _fl("topk"), _tdata(), rounds=ROUNDS, seed=SEED,
            eval_every=2, eval_examples=64, device="cpu"))


def test_engine_callback_gets_per_round_state():
    seen = {"ref": {}, "eng": {}}

    def cb(which):
        def f(r, state, metrics):
            seen[which][r] = dict(metrics)
            assert state["model"]["head"]["w"].shape[-1] == 10
        return f

    run_federated_reference(_bundle(), _fl("topk"), _tdata(), rounds=3,
                            seed=SEED, eval_examples=64, device="cpu",
                            callback=cb("ref"))
    eng = _engine("topk", rounds=3, superstep_rounds=4, callback=cb("eng"))
    assert seen["ref"] == seen["eng"] and sorted(seen["eng"]) == [0, 1, 2]
    assert eng.stats["chunks"] == 3


def test_trainer_fit_and_evaluate():
    trainer = FederatedTrainer(_bundle(), _fl("plain"), _tdata(),
                               RunOptions(seed=SEED, device="cpu"))
    with pytest.raises(RuntimeError, match="fit"):
        trainer.global_state
    res = trainer.fit(ROUNDS)
    assert trainer.result is res
    _assert_same(res, _engine("plain"))
    ev = trainer.evaluate(max_examples=64)
    assert ev == {k: res.comm.history[-1][k] for k in ("acc", "loss")}
    # the fig. 6 probe runs from the trained state (held to JAX's in
    # tests/test_torch_newclient.py)
    accs = trainer.newclient_probe(_tdata().clients[0], epochs=2, batch=8)
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)


@pytest.mark.parametrize("kw,fl_kw", [
    (dict(mesh=object()), {}), (dict(telemetry=True), {}),
    (dict(runlog="run.jsonl"), {}), (dict(halt_on_nonfinite=True), {}),
    (dict(profile_dir="prof"), {}),
    # participation runs on the engine; with telemetry it is still refused
    (dict(telemetry=True), dict(participation="deadline")),
    ({}, dict(controller="ef_ratio")),
], ids=["mesh", "telemetry", "runlog", "halt", "profile", "participation",
        "controller"])
def test_unported_engine_options_raise(kw, fl_kw, tmp_path):
    """Every case was a refusal once; each now runs and shows what it
    turns on (tests/test_torch_obs.py, tests/test_torch_control.py and
    tests/test_torch_sharded.py hold them to the JAX package).  ``mesh``
    takes a ``DeviceMesh`` only: anything else raises, and a 1 x 1 CPU
    mesh runs the single-device program (``client_shards == 1``)."""
    if "mesh" in kw:
        from repro_torch.launch.mesh import make_engine_mesh
        with pytest.raises((TypeError, ValueError), match="DeviceMesh"):
            _engine("topk", rounds=1, fl_kw=fl_kw, **kw)
        res = _engine("topk", rounds=2, fl_kw=fl_kw,
                      mesh=make_engine_mesh(device="cpu"))
        assert res.stats["client_shards"] == 1
        assert not res.stats["fused_collective"]
        assert not res.stats["sharded_eval"]
        _assert_same(res, _engine("topk", rounds=2, fl_kw=fl_kw))
        return
    kw = {k: str(tmp_path / v) if k in ("runlog", "profile_dir") else v
          for k, v in kw.items()}
    res = _engine("topk", rounds=2, fl_kw=fl_kw, **kw)
    hist = res.comm.history
    assert len(hist) == 2 and res.stats["halted_at"] is None
    if kw.get("telemetry"):
        assert res.stats["telemetry"]
        assert all("tele/ef_delta_ratio" in h for h in hist)
    if "runlog" in kw:
        names = [r["name"] for r in RunLog.load(kw["runlog"])]
        assert names[0] == "run.start" and names[-1] == "run.end"
        assert "chunk.dispatch" in names
    if "profile_dir" in kw:
        assert os.path.exists(res.stats["profile"])
    if fl_kw.get("participation"):
        assert res.stats["participation"] == "deadline"
        assert all("tele/effective_cohort" in h for h in hist)
    if fl_kw.get("controller"):
        assert res.stats["controller"] == "ef_ratio"
        assert all(h["level"] in (0, 1, 2) for h in hist)
    if not fl_kw:
        # run-time options read the run; they do not change it
        base = _engine("topk", rounds=2)
        for a, b in zip(tree_leaves(base.global_state),
                        tree_leaves(res.global_state)):
            assert torch.equal(a, b)


def test_engine_refuses_unknown_store_and_a_silent_cpu_fallback():
    with pytest.raises(ValueError, match="ef_store"):
        _engine("topk", rounds=1, ef_store="disk")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated_engine(_bundle(), _fl("plain"), _tdata(), rounds=1)


# --------------------------------------------------------------------------
# checkpoints: resume == uninterrupted, across stores and loops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,first,second", [
    ("plain", "engine", "engine"), ("topk", "engine", "engine"),
    ("topk", "engine", "engine/host"), ("topk", "engine/host", "engine"),
    ("topk", "engine", "reference"),
    ("int8-downtopk", "reference", "engine")],
    ids=["plain", "topk", "dense-to-host", "host-to-dense",
         "engine-to-reference", "reference-to-engine-quant"])
def test_checkpoint_resume_equals_uninterrupted(tmp_path, case, first,
                                                second):
    """Stop after 3 rounds (saves at 2 and 3), resume to 5: the state
    equals the uninterrupted run's, and the resumed rounds' history rows
    equal its rounds 4 and 5 (the CommLog restarts its count)."""
    def run(which, rounds, data):
        kw = dict(rounds=rounds, data=data,
                  checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
        if which == "reference":
            return run_federated_reference(
                _bundle(), _fl(case), kw.pop("data"), seed=SEED,
                eval_examples=64, device="cpu", **kw)
        store = "host" if which.endswith("/host") else "device"
        return _engine(case, superstep_rounds=4, ef_store=store, **kw)

    data = _tdata()
    run(first, 3, data)
    meta = json.load(open(tmp_path / "ckpt" / "meta.json"))
    assert meta == {"round": 3, "algorithm": _fl(case).algorithm,
                    "layout": "repro_torch"}
    resumed = run(second, ROUNDS, data)
    full = _reference(case, "client_parallel")
    for x, y in zip(tree_leaves(resumed.global_state),
                    tree_leaves(full.global_state)):
        assert torch.equal(x, y)
    assert resumed.comm.rounds == 2
    for got, want in zip(resumed.comm.history, full.comm.history[3:]):
        assert {k: v for k, v in got.items()
                if k not in ("round", "cum_bytes_up")} == \
            {k: v for k, v in want.items()
             if k not in ("round", "cum_bytes_up")}


def _npz_shapes(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files}


def test_checkpoint_layout_matches_jax(tmp_path):
    """The port writes the JAX package's meta.json, plus its own layout
    marker, and the same .npz keys; shapes agree once the conv weights'
    HWIO -> OIHW layout and the EF leaves' order (JAX sorts a dict's
    keys) are mapped."""
    fl_kw = {**BASE, **CASES["fusion-topk"]}
    parts, test = _parts()
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **NARROW))
    j_ref(jb, JFL(**fl_kw), JFD(parts, test, seed=0), rounds=2, seed=SEED,
          eval_examples=64, checkpoint_dir=str(tmp_path / "jax"))
    _engine("fusion-topk", rounds=2, checkpoint_dir=str(tmp_path / "port"))
    for f in ("meta.json",):
        assert {**json.load(open(tmp_path / "jax" / f)),
                "layout": "repro_torch"} == \
            json.load(open(tmp_path / "port" / f))

    def port_shape(key, shape):
        parts_ = key.split("/")
        if "convs" in parts_ and parts_[-1] == "w":     # OIHW -> HWIO
            o, i, h, w = shape
            return (h, w, i, o)
        return shape

    js = _npz_shapes(tmp_path / "jax" / "state.npz")
    ts = _npz_shapes(tmp_path / "port" / "state.npz")
    assert set(js) == set(ts)
    assert all(js[k] == port_shape(k, ts[k]) for k in js)
    je = _npz_shapes(tmp_path / "jax" / "ef.npz")
    te = _npz_shapes(tmp_path / "port" / "ef.npz")
    assert set(je) == set(te)
    # EF leaf i is model leaf i in each package's own leaf order
    s0 = j_init_global_state(jb, JFL(**fl_kw), jax.random.PRNGKey(0))
    jpaths = ["/".join(str(getattr(p, "key", f"#{getattr(p, 'idx', '')}"))
                       for p in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  s0["model"])[0]]
    tpaths = [k[len("#1/"):] for k in te if k.startswith("#1/")]
    for i, path in enumerate(jpaths):
        j = tpaths.index(path)
        assert je[f"#0/#{i}"] == te[f"#0/#{j}"]
        assert je[f"#1/{path}"] == port_shape(path, te[f"#1/{path}"])


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,mode", [("plain", "client_parallel"),
                                       ("topk", "client_sequential"),
                                       ("fusion-topk", "client_parallel")])
def test_engine_matches_jax_reference(case, mode):
    """From the converted JAX initial state, 4-round chunks: final model
    within rtol 1e-4 / atol 1e-5 of JAX's reference loop, losses alike,
    identical bytes."""
    fl_kw = {**BASE, **CASES[case]}
    parts, test = _parts()
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **NARROW))
    jfl = JFL(**fl_kw)
    jres = j_ref(jb, jfl, JFD(parts, test, seed=0), rounds=ROUNDS, seed=SEED,
                 mode=mode, eval_examples=64)
    s0 = jax.tree.map(np.asarray,
                      j_init_global_state(jb, jfl, jax.random.PRNGKey(SEED)))
    tres = run_federated(_bundle(), TFL(**fl_kw), _tdata(), rounds=ROUNDS,
                         mode=mode, eval_examples=64, superstep_rounds=4,
                         global_state=state_from_numpy(s0), device="cpu")
    _check(jres, tres, N_TEST)


@pytest.mark.parametrize("kw", [dict(), dict(eval_every=3),
                                dict(ckpt_every=4), dict(eval_every=2,
                                                         ckpt_every=3),
                                dict(per_round=True)])
@pytest.mark.parametrize("start,rounds,chunk", [(0, 20, 8), (3, 17, 5),
                                                (0, 7, 1), (5, 5, 8)])
def test_chunk_schedule_matches_jax(start, rounds, chunk, kw):
    assert chunk_schedule(start, rounds, chunk, **kw) == \
        j_chunk_schedule(start, rounds, chunk, **kw)


def test_round_chunk_matches_jax_and_the_per_round_draws():
    parts, test = _parts()
    j = JFD(parts, test, seed=3).round_chunk(3, 2, 2, 8)
    pool = StagingPool()
    t = TFD(parts, test, seed=3).round_chunk(3, 2, 2, 8, pool=pool)
    np.testing.assert_array_equal(t[0], j[0])
    for k in j[1]:
        np.testing.assert_array_equal(t[1][k], j[1][k])
    np.testing.assert_array_equal(t[2], j[2])
    assert t[0].dtype == np.int32 and t[2].dtype == np.float32
    # K rounds of sample_clients + round_batch, in the same order
    d = TFD(parts, test, seed=3)
    for r in range(3):
        cids = d.sample_clients(2)
        b, s = d.round_batch(cids, 2, 8)
        np.testing.assert_array_equal(t[0][r], cids)
        np.testing.assert_array_equal(t[1]["x"][r], b["x"])
        np.testing.assert_array_equal(t[2][r], s)
    # the pool's buffers back the arrays and are reused
    assert pool.tensor("cids").data_ptr() == t[0].ctypes.data
    TFD(parts, test, seed=4).round_chunk(3, 2, 2, 8, pool=pool)
    assert pool.hits == 4 and pool.misses == 4


def test_staging_pool_refuses_a_refill_before_release():
    pool = StagingPool()
    pool.acquire()
    with pytest.raises(RuntimeError, match="released"):
        pool.acquire()
    pool.release(None)
    pool.acquire()


def test_noise_source_depends_on_the_round_only():
    """A round's offsets are a function of (seed, round): drawing round 2
    first or after rounds 0 and 1 gives the same numbers (so a resumed run
    draws what an uninterrupted one does)."""
    bundle = _bundle()
    codec = _quant_codec(bundle)
    a = make_noise_source(codec, codec, 5, "cpu")
    b = make_noise_source(codec, codec, 5, "cpu")
    a(0, 2), a(1, 2)
    (da, ua), (db, ub) = a(2, 2), b(2, 2)
    assert all(torch.equal(x, y) for x, y in zip(da, db))
    assert all(torch.equal(x, y) for cx, cy in zip(ua, ub)
               for x, y in zip(cx, cy))
    assert not torch.equal(b(3, 2)[0][0], db[0])


def _quant_codec(bundle):
    from repro_torch.compress import make_codec
    params = bundle.init(torch.Generator().manual_seed(0))
    return make_codec("int8").bind(params)


def test_auto_chunk_rounds_from_two_timings():
    # t_K = 0.9 + 0.1 K: overhead 0.9 s, 0.1 s a round -> K = 180
    assert _auto_chunk_rounds(lambda k: 0.9 + 0.1 * k) == 180
    assert _auto_chunk_rounds(lambda k: 0.001 + 1.0 * k) == 8
    assert _auto_chunk_rounds(lambda k: 100.0 + 1e-3 * k) == 256


def test_metrics_pump_merges_eval_into_the_chunks_last_round():
    comm = CommLog()
    comm.bind_sizes({"model": {"w": torch.zeros(3)}})
    with MetricsPump(comm, 2, max_pending=1) as pump:
        pump.submit({"local_loss": torch.tensor([1.0, 2.0])},
                    {"acc": torch.tensor(0.5)})
        pump.submit({"local_loss": torch.tensor([3.0])})
    assert [h["local_loss"] for h in comm.history] == [1.0, 2.0, 3.0]
    assert [("acc" in h) for h in comm.history] == [False, True, False]
    assert comm.history[-1]["bytes_up"] == 2 * 12
