"""The port's LM engine against the JAX package's engine, on the CPU:
the paper's two-stream algorithms (FedFusion-conv, FedMMD), the int8
uplink with JAX's stochastic-rounding offsets, and partial participation
with chaos, the telemetry taps and the ``ef_ratio`` controller on a top-k
uplink, whose JAX checkpoint (top-k EF table included) the port resumes.
The settings, helpers and tolerances are ``tests/test_torch_lm_engine.py``'s
(split in two files so that each runs in its own test worker).
"""
import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_lm_engine import (CHAOS_KW, N_CLIENTS, ROUNDS, RTOL, SEED,
                                  JChaos, JFD, JFL, _bundles, _close_rows,
                                  _close_state, _close_history, _data, _fl,
                                  _jax_and_port, _jax_state, _port_order,
                                  j_run_federated)
from test_torch_lm_engine import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.checkpoint.convert import _jax_leaf_paths, load_jax_ef
from repro_torch.checkpoint.io import _paths
from repro_torch.data import ChaosConfig
from repro_torch.fl.server import run_federated
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.tree import tree_leaves


# FedFusion-conv from this random init diverges at lr 0.05 (its local loss
# climbs from 108 to 791 in 4 rounds, in both packages alike), and two
# diverging float32 runs part at any tolerance; at lr 0.02 it trains
JAX_CASES = [("smollm-135m", "fedfusion", dict(lr=0.02)),
             ("gemma3-1b", "fedmmd", {})]


@pytest.mark.parametrize("name,algo,fl_kw", JAX_CASES,
                         ids=[f"{n}-{a}" for n, a, _ in JAX_CASES])
def test_lm_engine_matches_jax_engine(name, algo, fl_kw):
    jres, tres, _ = _jax_and_port(name, algo, fl_kw, rounds=ROUNDS,
                                  eval_every=2, eval_examples=8,
                                  superstep_rounds=2)
    _close_state(tres, jres.global_state)
    _close_history(tres, jres)


def test_lm_engine_int8_matches_jax_engine(monkeypatch):
    """int8 with JAX's offsets: ``floor(x / scale + u)`` is a step
    function, so the float32 drift of the trained deltas between XLA and
    PyTorch flips a code by one where ``x / scale + u`` lies within that
    drift of an integer (a handful of the 1.2 M codes of a round here).
    ``tests/test_torch_compressed_rounds.py``'s rule holds: the final model
    within 2 of the run's largest quant step (rtol 0), bytes identical;
    round 1's local loss, trained before any code is sent, at rtol 1e-4."""
    jres, tres, scales = _jax_and_port(
        "smollm-135m", "fedavg", dict(uplink_codec="int8"), monkeypatch,
        rounds=2, eval_every=2, eval_examples=8, superstep_rounds=2)
    step = max(scales)
    got = jax.tree.leaves(state_to_numpy(tres.global_state))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jres.global_state))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * step)
    np.testing.assert_allclose(tres.comm.history[0]["local_loss"],
                               jres.comm.history[0]["local_loss"], rtol=RTOL)
    byte_keys = ("bytes_up", "bytes_down", "bytes_up_ideal", "cum_bytes_up")
    assert [{k: h[k] for k in byte_keys} for h in tres.comm.history] == [
        {k: h[k] for k in byte_keys} for h in jres.comm.history]


def test_lm_engine_participation_controller_and_jax_checkpoint(tmp_path):
    """``deadline`` with chaos, every telemetry tap and the ``ef_ratio``
    controller on a top-k ladder.  JAX's engine runs 2 rounds with a
    checkpoint every round; the port's first round is held to JAX's (top-k
    over one round: the schedule, the taps' values, bytes, the state);
    then JAX's round-1 checkpoint (state, top-k EF table, mirror,
    controller state) is resumed by the port for round 2, beside JAX's
    round 2."""
    name = "smollm-135m"
    jb, tb = _bundles(name)
    fl_kw = dict(participation="deadline", over_provision=1.5,
                 uplink_codec="topk", topk_frac=0.25, controller="ef_ratio",
                 ctrl_band=(0.4, 0.9), ctrl_ema=0.5)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    kw = dict(seed=SEED, eval_every=1, eval_examples=8, superstep_rounds=1,
              telemetry=True, checkpoint_every=1)
    snap = {}

    def grab(r, state, metrics):
        # before round r + 1's save: the state after round 1, then the
        # directory holding round 1's checkpoint
        if r == 0:
            snap["state"] = jax.tree.map(np.array, state)
        else:
            shutil.copytree(jdir, tdir)

    jres = j_run_federated(jb, _fl(JFL, **fl_kw), _data(
        JFD, chaos=JChaos(**CHAOS_KW)), rounds=2, checkpoint_dir=str(jdir),
        callback=grab, **kw)
    state = _port_order(name, "fedavg", state_from_numpy(
        _jax_state(name, "fedavg")))
    t1 = run_federated(tb, _fl(**fl_kw), _data(chaos=ChaosConfig(
        **CHAOS_KW)), rounds=1, device="cpu", global_state=state,
        **{k: v for k, v in kw.items() if k != "checkpoint_every"})
    assert t1.stats["participation"] == "deadline"
    assert t1.stats["controller"] == "ef_ratio"
    assert {"sim_time", "arrived", "level"} <= set(t1.comm.history[0])
    assert any(k.startswith("tele/") for k in t1.comm.history[0])
    _close_state(t1, snap["state"])
    _close_rows(t1.comm.history, jres.comm.history[:1])
    # the resumed round selects its own top-k: where the two sides'
    # deltas order two entries at the threshold differently, the entry
    # moves between the update and the EF residual (2 of the 1.2 M here, by
    # 2.6% of the round's largest change), so the resumed state is not held
    # to JAX's.  Held instead: the converted EF table equals JAX's rows,
    # leaf by leaf path, and the resumed round's local loss (trained from
    # the converted state), schedule and bytes equal JAX's
    model = t1.global_state["model"]
    ef, _ = load_jax_ef(str(tdir / "ef.npz"), [
        torch.empty((N_CLIENTS,) + tuple(x.shape), device="meta")
        for x in tree_leaves(model)], model, "cpu")
    jpaths = [p for p, _ in _jax_leaf_paths(model)]
    with np.load(tdir / "ef.npz") as z:
        for (p, _), rows in zip(_paths(model), ef):
            want = z[f"#0/#{jpaths.index(p)}"]
            assert want.any()
            np.testing.assert_array_equal(rows.numpy(),
                                          want.reshape(N_CLIENTS, -1))
    t2 = run_federated(tb, _fl(**fl_kw), _data(chaos=ChaosConfig(
        **CHAOS_KW)), rounds=2, device="cpu", checkpoint_dir=str(tdir),
        checkpoint_from_jax=True, ef_store="host", **kw)
    assert t2.stats["ef_store"] == "host" and len(t2.comm.history) == 1
    h, hj = t2.comm.history[0], jres.comm.history[1]
    assert set(h) == set(hj)
    for k in ("level", "sim_time", "arrived", "bytes_up", "bytes_down"):
        assert h[k] == hj[k], k
    np.testing.assert_allclose(h["local_loss"], hj["local_loss"], rtol=RTOL)
