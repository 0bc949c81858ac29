"""The port's federated training loop against the JAX package's
``run_federated_reference``, seed for seed, on the CPU.

Both loops start from the same (converted) JAX initial state and sample
the same cohorts and batches from the same numpy stream.  Tolerances:
every step's forward and backward agree to float32 rounding (~1e-7
relative, from XLA's and PyTorch's different summation orders); over 3
rounds of SGD that drift stays well inside rtol 1e-4 / atol 1e-5 on the
final parameters.  Per-round local loss and eval loss are held to atol
1e-5 and rtol 1e-4; eval accuracy may differ by at most one flipped
prediction.  ``CommLog`` byte counts depend only on shapes and must be
identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.fl.server import run_federated_reference as j_run
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import CNN_MNIST as T_MNIST
from repro_torch.configs import FLConfig as TFL
from repro_torch.data import FederatedDataset as TFD
from repro_torch.data import artificial_noniid_partition, class_images
from repro_torch.fl.comm import CommLog
from repro_torch.fl.server import run_federated_reference as t_run
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.models import make_bundle

NARROW = dict(input_shape=(12, 12, 1), conv_channels=(4, 8), fc_units=(16,))
BYTE_KEYS = ("round", "bytes_up", "bytes_down", "bytes_up_ideal",
             "cum_bytes_up")


def _data(shape, n_clients, n_test):
    x, y = class_images(10, shape=shape, seed=0, template_seed=0)
    xt, yt = class_images(-(-n_test // 10), shape=shape, seed=1,
                          template_seed=0)
    parts = artificial_noniid_partition(x, y, n_clients, shards_per_client=2)
    return parts, {"x": xt[:n_test], "y": yt[:n_test]}


def _run_both(fl_kw, mode, *, cnn=NARROW, rounds=3, n_clients=4,
              n_test=40, seed=1):
    jcfg = dataclasses.replace(J_MNIST, **cnn)
    tcfg = dataclasses.replace(T_MNIST, **cnn)
    jb, tb = j_make_bundle(jcfg), make_bundle(tcfg)
    parts, test = _data(jcfg.input_shape, n_clients, n_test)
    jfl, tfl = JFL(**fl_kw), TFL(**fl_kw)
    jres = j_run(jb, jfl, JFD(parts, test, seed=0), rounds=rounds, seed=seed,
                 mode=mode, eval_examples=64)
    s0 = jax.tree.map(np.asarray,
                      j_init_global_state(jb, jfl, jax.random.PRNGKey(seed)))
    tres = t_run(tb, tfl, TFD(parts, test, seed=0), rounds=rounds, mode=mode,
                 eval_examples=64, global_state=state_from_numpy(s0),
                 device="cpu")
    return jres, tres, n_test


def _check(jres, tres, n_test):
    want = jax.tree.map(np.asarray, jres.global_state)
    got = state_to_numpy(tres.global_state)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert len(tres.comm.history) == len(jres.comm.history)
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        assert {k: ht[k] for k in BYTE_KEYS} == {k: hj[k] for k in BYTE_KEYS}
        assert set(ht) == set(hj)
        np.testing.assert_allclose(ht["local_loss"], hj["local_loss"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-4,
                                   atol=1e-5)
        assert abs(ht["acc"] - hj["acc"]) <= 1.0 / n_test + 1e-6
    assert (tres.comm.bytes_up, tres.comm.bytes_down) == \
        (jres.comm.bytes_up, jres.comm.bytes_down)


ALGOS = [("fedavg", "multi"), ("fedmmd", "multi"), ("fedl2", "multi"),
         ("fedfusion", "conv"), ("fedfusion", "multi")]


@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
@pytest.mark.parametrize("algorithm,fusion_op", ALGOS)
def test_three_rounds_match_jax(algorithm, fusion_op, mode):
    fl_kw = dict(algorithm=algorithm, fusion_op=fusion_op,
                 clients_per_round=4, local_steps=2, local_batch=8, lr=0.05)
    _check(*_run_both(fl_kw, mode))


@pytest.mark.parametrize("extra", [
    dict(algorithm="fedmmd", local_epochs=2),            # §3.3 feature cache
    dict(algorithm="fedfusion", fusion_op="conv", local_epochs=2),
    dict(algorithm="fedavg", momentum=0.9),
    dict(algorithm="fedl2", optimizer="adam", lr=0.01),
    dict(algorithm="fedfusion", fusion_op="single", lr_decay=0.9),
], ids=["mmd-cache", "fusion-cache", "momentum", "adam", "single-decay"])
def test_options_match_jax(extra):
    fl_kw = dict(clients_per_round=3, local_steps=2, local_batch=8, lr=0.05)
    fl_kw.update(extra)
    _check(*_run_both(fl_kw, "client_parallel", rounds=2))


@pytest.mark.parametrize("algorithm", ["fedmmd", "fedfusion"])
def test_full_width_single_step_matches_jax(algorithm):
    fl_kw = dict(algorithm=algorithm, fusion_op="conv", clients_per_round=2,
                 local_steps=1, local_batch=10, lr=0.08)
    _check(*_run_both(fl_kw, "client_parallel", cnn={}, rounds=1,
                      n_clients=4, n_test=20))


@pytest.mark.parametrize("kw,opt", [
    # the sketch codecs are ported: cases 0 and 3 hold the reference loop's
    # other refusals (participation, controllers are engine features); a
    # controller needs a ladder-capable uplink (FLConfig checks it, as
    # JAX's does), so the controller cases name one
    (dict(participation="buffered_async"), {}),
    (dict(participation="deadline"), {}),
    (dict(controller="ef_ratio", uplink_codec="topk"), {}),
    (dict(controller="bytes_budget", uplink_codec="int8"), {}),
])
def test_unported_settings_raise(kw, opt):
    tb = make_bundle(dataclasses.replace(T_MNIST, **NARROW))
    parts, test = _data((12, 12, 1), 4, 10)
    with pytest.raises(NotImplementedError):
        t_run(tb, TFL(**kw), TFD(parts, test), rounds=1, device="cpu", **opt)


def test_commlog_records_and_milestones(tmp_path):
    tb = make_bundle(dataclasses.replace(T_MNIST, **NARROW))
    parts, test = _data((12, 12, 1), 4, 10)
    fl = TFL(algorithm="fedfusion", fusion_op="conv", clients_per_round=2,
             local_steps=1, local_batch=4, lr=0.05)
    res = t_run(tb, fl, TFD(parts, test), rounds=2, seed=3, device="cpu")
    recs = res.comm.to_records()
    assert [r["kind"] for r in recs] == ["round", "round", "summary"]
    assert recs[-1] == {"kind": "summary", "schema": 2, "rounds": 2,
                        "bytes_up": res.comm.bytes_up,
                        "bytes_down": res.comm.bytes_down}
    path = res.comm.save(str(tmp_path / "comm.jsonl"))
    assert len(open(path).read().splitlines()) == 3
    assert res.comm.rounds_to("acc", -1.0) == 1
    assert res.comm.rounds_to("acc", 2.0) == -1
    bound = CommLog().bind_sizes(res.global_state)
    bound.log_round(None, 2, {})
    assert bound.history[0]["bytes_up"] == res.comm.history[0]["bytes_up"]
    with pytest.raises(RuntimeError):
        CommLog().log_round(None, 2, {})


def test_port_native_init_runs_and_is_seeded():
    tb = make_bundle(dataclasses.replace(T_MNIST, **NARROW))
    parts, test = _data((12, 12, 1), 4, 10)
    fl = TFL(algorithm="fedmmd", clients_per_round=2, local_steps=1,
             local_batch=4, lr=0.05)
    a, b = (t_run(tb, fl, TFD(parts, test), rounds=1, seed=4, device="cpu")
            for _ in range(2))
    for u, v in zip(jax.tree.leaves(a.global_state),
                    jax.tree.leaves(b.global_state)):
        assert isinstance(u, torch.Tensor) and torch.equal(u, v)
    assert np.isfinite(a.comm.history[0]["local_loss"])
