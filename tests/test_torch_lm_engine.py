"""The port's engine on LM bundles (``repro_torch.engine`` over the
transformer), on the CPU, at reduced size (2 layers, vocab 64, 2 local
steps of 2 sequences of 16 tokens, 2 of 4 clients a round):

* against the port's own reference loop, exactly (the same draws,
  learning rates and per-round math, so the final model and the
  ``CommLog`` history are equal, as ``tests/test_torch_engine.py`` holds
  the CNN): FedAvg, FedMMD, FedFusion-conv and FedL2, each in both round
  modes and on both models, 4 rounds in 2-round chunks, eval folded into
  the chunk and at chunk boundaries, and a top-k uplink on the dense and
  the host EF store;
* against the JAX package's engine (``repro.fl.server.run_federated``)
  from the converted JAX state, uncompressed FedAvg and FedL2 (the
  two-stream algorithms, the int8 uplink, participation, the controller
  and a JAX checkpoint's resume are ``tests/test_torch_lm_engine_jax.py``,
  which shares this file's helpers).  The converted state is re-keyed in
  the port's own order (``embed, final_norm, cycles, tail``; JAX flattens
  dict keys sorted), so whatever pairs per-leaf values across the
  packages (JAX's int8 offsets through ``noise_fn``, the EF table) pairs
  them by leaf path;
* a stopped and resumed LM engine run equals the uninterrupted one;
* ``launch.train --engine`` (JAX's federation and flags, a CPU run) and
  the example twin ``examples/train_lm_federated_torch.py``.

The port runs ``attn_impl="pallas"`` (the plain K8a / K8b / K8c versions
on the CPU), JAX ``attn_impl="jnp"``.  Tolerances against JAX: the state
at rtol 1e-4 / atol 1e-5, losses likewise, accuracy within one token of
the 128 evaluated (8 sequences of 16), bytes equal.
"""
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_inputs import reduced
from test_torch_compress import _jax_offsets

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import ChaosConfig as JChaos
from repro.data.federated import FederatedDataset as JFD
from repro.fl.server import run_federated as j_run_federated
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.checkpoint.convert import _jax_leaf_paths
from repro_torch.checkpoint.io import _paths
from repro_torch.configs import FLConfig, get_config
from repro_torch.core.rounds import init_global_state
from repro_torch.data import (ChaosConfig, FederatedDataset,
                              source_partition, token_stream)
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import train
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-4, 1e-5
VOCAB, SEQ, N_CLIENTS, ROUNDS, SEED = 64, 16, 4, 4, 1
EVAL_TOKENS = 8 * SEQ           # 8 test sequences of 16 next tokens
BASE = dict(clients_per_round=2, local_steps=2, local_batch=2, lr=0.05,
            fusion_op="conv")
COMP = 0x636f6d70               # "comp": the JAX engine's codec key salt
CHAOS_KW = dict(speed_sigma=1.0, jitter=0.2, dropout=0.3, truncation=0.3,
                seed=7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the reduced LM's ops are small
    enough to run as fast on one, and the test workers share the
    machine's cores, where eight threads each would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _cfgs(name):
    return (reduced(J_ARCHS[name], attn_impl="jnp", vocab_size=VOCAB),
            reduced(get_config(name), attn_impl="pallas", vocab_size=VOCAB))


@functools.cache
def _bundles(name):
    jcfg, tcfg = _cfgs(name)
    return j_make_bundle(jcfg), make_bundle(tcfg)


@functools.cache
def _tokens():
    toks, src = token_stream(64, SEQ, vocab=VOCAB, n_sources=N_CLIENTS,
                             seed=0)
    test, _ = token_stream(8, SEQ, vocab=VOCAB, n_sources=N_CLIENTS, seed=1)
    return source_partition(toks, src, N_CLIENTS), {"tokens": test}


def _data(cls=FederatedDataset, chaos=None):
    parts, test = _tokens()
    return cls(parts, test, seed=0, chaos=chaos)


def _fl(cls=FLConfig, **kw):
    return cls(**{**BASE, **kw})


def _assert_same(a, b):
    """The engine's rule against the reference loop: every leaf and the
    whole CommLog history equal."""
    for x, y in zip(tree_leaves(a.global_state), tree_leaves(b.global_state)):
        assert torch.equal(x, y), (x - y).abs().max().item()
    assert a.comm.history == b.comm.history
    assert (a.comm.bytes_up, a.comm.bytes_down) == (b.comm.bytes_up,
                                                    b.comm.bytes_down)


# --------------------------------------------------------------------------
# the engine against the port's reference loop: exact
# --------------------------------------------------------------------------

ALGOS = {"fedavg": {}, "fedmmd": dict(algorithm="fedmmd"),
         "fedfusion": dict(algorithm="fedfusion"),
         "fedl2": dict(algorithm="fedl2")}


# every algorithm in both round modes and on both models; eval folded into
# the chunk (eval every round) with client_parallel, at chunk boundaries
# (eval every 2 rounds) with client_sequential
REF_CASES = [("smollm-135m", "fedavg", "client_parallel"),
             ("smollm-135m", "fedmmd", "client_sequential"),
             ("smollm-135m", "fedfusion", "client_parallel"),
             ("smollm-135m", "fedl2", "client_sequential"),
             ("gemma3-1b", "fedavg", "client_sequential"),
             ("gemma3-1b", "fedmmd", "client_parallel"),
             ("gemma3-1b", "fedfusion", "client_sequential"),
             ("gemma3-1b", "fedl2", "client_parallel")]


@pytest.mark.parametrize("name,algo,mode", REF_CASES,
                         ids=["-".join(c) for c in REF_CASES])
def test_lm_engine_equals_port_reference(name, algo, mode):
    eval_every = 1 if mode == "client_parallel" else 2
    fl = _fl(**ALGOS[algo])
    bundle = _bundles(name)[1]
    kw = dict(rounds=ROUNDS, seed=SEED, mode=mode, eval_every=eval_every,
              eval_examples=8, device="cpu")
    eng = run_federated(bundle, fl, _data(), superstep_rounds=2, **kw)
    _assert_same(eng, run_federated_reference(bundle, fl, _data(), **kw))
    st = eng.stats
    assert st["eval_in_chunk"] == (eval_every == 1)
    assert st["chunks"] == ROUNDS // 2 and not st["cuda_graphs"]
    assert [("acc" in h) for h in eng.comm.history] == [
        (r + 1) % eval_every == 0 for r in range(ROUNDS)]


def test_lm_engine_topk_dense_and_host_store_equal_reference():
    fl = _fl(algorithm="fedfusion", uplink_codec="topk", topk_frac=1 / 16)
    bundle = _bundles("smollm-135m")[1]
    kw = dict(rounds=ROUNDS, seed=SEED, eval_every=2, eval_examples=8,
              device="cpu")
    ref = run_federated_reference(bundle, fl, _data(), **kw)
    for store in ("device", "host"):
        eng = run_federated(bundle, fl, _data(), superstep_rounds=2,
                            ef_store=store, **kw)
        _assert_same(eng, ref)
        assert eng.stats["ef_store"] == store


# --------------------------------------------------------------------------
# against the JAX package's engine, from the converted JAX state
# --------------------------------------------------------------------------

@functools.cache
def _jax_state(name, algo):
    jb = _bundles(name)[0]
    return jax.tree.map(np.asarray, j_init_global_state(
        jb, _fl(JFL, **ALGOS[algo]), jax.random.PRNGKey(SEED)))


def _port_order(name, algo, state):
    """``state`` (converted: dict keys in JAX's sorted order) re-keyed in
    the port's own order (``embed, final_norm, cycles, tail``), so that
    leaf order differs between the packages as in a run the port seeds."""
    like = init_global_state(_bundles(name)[1], _fl(**ALGOS[algo]),
                             torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda _, x: x, like, state)


def _jax_noise_fn(jstate_model, port_model):
    """``noise_fn(r, n_clients)`` giving the port the uplink offsets JAX's
    engine draws (key ``fold_in(fold_in(PRNGKey(seed), "comp"), r)``,
    split into downlink and uplink, the uplink over the clients, then
    over the leaves in JAX's order), each leaf's handed to the port's leaf
    of the same path."""
    jpaths = [p for p, _ in _jax_leaf_paths(jstate_model)]
    sizes = [x.size for _, x in _jax_leaf_paths(jstate_model)]
    order = [jpaths.index(p) for p, _ in _paths(port_model)]

    def noise_fn(r, n_clients):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), COMP), r)
        _, ku = jax.random.split(key)
        ups = [_jax_offsets(k, sizes) for k in jax.random.split(ku, n_clients)]
        return None, [[torch.from_numpy(u[i]) for i in order] for u in ups]

    return noise_fn


def _close_state(tres, jstate):
    got = jax.tree.leaves(state_to_numpy(tres.global_state))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _close_history(tres, jres):
    _close_rows(tres.comm.history, jres.comm.history)
    assert (tres.comm.bytes_up, tres.comm.bytes_down) == (
        jres.comm.bytes_up, jres.comm.bytes_down)


def _close_rows(trows, jrows):
    """CommLog rows: the same keys, floats at the state's tolerance (acc
    within one token flip), the rest (round, bytes) equal."""
    assert len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        assert set(t) == set(j)
        for k, v in j.items():
            if k == "acc":
                assert abs(t[k] - v) <= 1 / EVAL_TOKENS + 1e-7
            elif isinstance(v, float):
                np.testing.assert_allclose(t[k], v, rtol=RTOL, atol=ATOL,
                                           err_msg=k)
            else:
                assert t[k] == v, k


JAX_CASES = [("smollm-135m", "fedavg", {}), ("gemma3-1b", "fedl2", {})]


def _jax_and_port(name, algo, fl_kw, monkeypatch=None, chaos=None, **kw):
    """JAX's engine from its seeded state and the port's from the same
    state converted (re-keyed in the port's order), with JAX's offsets
    when the uplink quantizes.  With ``monkeypatch`` JAX's quant codec
    records each leaf's scale.  Returns ``(jax_result, port_result,
    scales)``."""
    jb, tb = _bundles(name)
    s0 = _jax_state(name, algo)
    scales = []
    if monkeypatch is not None:
        import repro.engine.engine as j_engine
        from repro import compress as jcomp
        from test_torch_compressed_rounds import _JaxRecQuant, _recording
        logs = []
        monkeypatch.setattr(j_engine, "make_codec", _recording(
            jcomp.make_codec, _JaxRecQuant, logs))
    jres = j_run_federated(jb, _fl(JFL, **ALGOS[algo], **fl_kw), _data(
        JFD, chaos=chaos and JChaos(**chaos)), seed=SEED, **kw)
    if monkeypatch is not None:
        scales = [sc for log in logs for *_, sc in log]
    state = _port_order(name, algo, state_from_numpy(s0))
    quant = fl_kw.get("uplink_codec") in ("int8", "int4")
    tres = run_federated(tb, _fl(**ALGOS[algo], **fl_kw), _data(
        chaos=chaos and ChaosConfig(**chaos)), seed=SEED, device="cpu",
        global_state=state,
        noise_fn=_jax_noise_fn(s0["model"], state["model"]) if quant
        else None, **kw)
    return jres, tres, scales


@pytest.mark.parametrize("name,algo,fl_kw", JAX_CASES,
                         ids=[f"{n}-{a}" for n, a, _ in JAX_CASES])
def test_lm_engine_matches_jax_engine(name, algo, fl_kw):
    jres, tres, _ = _jax_and_port(name, algo, fl_kw, rounds=ROUNDS,
                                  eval_every=2, eval_examples=8,
                                  superstep_rounds=2)
    _close_state(tres, jres.global_state)
    _close_history(tres, jres)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_lm_engine_resume_equals_uninterrupted(tmp_path):
    fl = _fl(uplink_codec="topk", topk_frac=1 / 16)
    bundle = _bundles("gemma3-1b")[1]
    kw = dict(seed=SEED, eval_every=2, eval_examples=8, superstep_rounds=2,
              ef_store="host", device="cpu")
    whole = run_federated(bundle, fl, _data(), rounds=ROUNDS, **kw)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    run_federated(bundle, fl, _data(), rounds=2, **ck, **kw)
    resumed = run_federated(bundle, fl, _data(), rounds=ROUNDS, **ck, **kw)
    for x, y in zip(tree_leaves(whole.global_state),
                    tree_leaves(resumed.global_state)):
        assert torch.equal(x, y)
    assert resumed.comm.rounds == 2
    for got, want in zip(resumed.comm.history, whole.comm.history[2:]):
        assert {k: v for k, v in got.items()
                if k not in ("round", "cum_bytes_up")} == \
            {k: v for k, v in want.items()
             if k not in ("round", "cum_bytes_up")}


# --------------------------------------------------------------------------
# the launcher's --engine and the example twin
# --------------------------------------------------------------------------

ENGINE_FLAGS = [[], ["--participation", "deadline", "--over-provision", "2",
                     "--chaos", "--chaos-dropout", "0.2", "--controller",
                     "ef_ratio", "--ladder", "0.0125,0.025,0.05",
                     "--ef-store", "host", "--telemetry",
                     "--halt-on-nonfinite"]]


@pytest.mark.parametrize("flags", ENGINE_FLAGS, ids=["defaults", "knobs"])
def test_launch_train_engine_builds_jax_federation(flags, monkeypatch):
    import repro.fl.api as j_api
    import repro.launch.train as j_train
    common = ["--engine", "--rounds", "4", "--seq-len", "16",
              "--global-batch", "2", *flags]
    got = {}

    class Capture:
        def __init__(self, bundle, fl, data, opts):
            got.update(fl=fl, data=data, opts=opts)

        def fit(self, rounds):
            raise SystemExit(0)

    monkeypatch.setattr(j_api, "FederatedTrainer", Capture)
    monkeypatch.setattr(sys, "argv", ["train.py", *common])
    with pytest.raises(SystemExit):
        j_train.main()
    targs = {}
    monkeypatch.setattr(train, "run_engine",
                        lambda args, cfg, fl: targs.update(args=args, cfg=cfg,
                                                           fl=fl))
    train.main([*common, "--device", "cpu"])
    # every flag with JAX's name and default (the port adds --device and
    # --attn-impl)
    jargs, pargs = vars(_jax_args(common, monkeypatch)), vars(targs["args"])
    assert set(pargs) - set(jargs) == {"device", "attn_impl"}
    assert {k: pargs[k] for k in jargs} == jargs
    run = train.engine_setup(targs["args"], targs["cfg"], targs["fl"])
    # the same federation: config, client count, token arrays, options
    jfl, tfl = dataclasses.asdict(got["fl"]), dataclasses.asdict(run["fl"])
    shared = set(jfl) & set(tfl)
    assert len(shared) >= 25      # (the port has no weighted_by_examples)
    assert {k: tfl[k] for k in shared} == {k: jfl[k] for k in shared}
    jd, td = got["data"], run["data"]
    assert len(jd.clients) == len(td.clients) == run["n_clients"]
    for a, b in zip(jd.clients, td.clients):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(jd.test["tokens"], td.test["tokens"])
    assert (jd.chaos is None) == (td.chaos is None)
    if jd.chaos is not None:
        assert dataclasses.asdict(jd.chaos) == dataclasses.asdict(td.chaos)
    jo, to = got["opts"], run["options"]
    assert (jo.eval.every, jo.eval.examples) == (to.eval.every,
                                                 to.eval.examples)
    je, te = jo.engine, to.engine
    for k in ("superstep_rounds", "ef_store", "telemetry", "runlog",
              "halt_on_nonfinite", "profile_dir"):
        assert getattr(je, k) == getattr(te, k), k
    assert run["mesh"] is None and run["shards"] == 1


def _jax_args(argv, monkeypatch):
    """JAX's parsed launcher arguments for ``argv``."""
    import repro.launch.train as j_train
    seen = {}
    monkeypatch.setattr(j_train, "run_engine",
                        lambda args, cfg, fl: seen.update(args=args))
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    j_train.main()
    return seen["args"]


def test_launch_train_engine_runs_on_the_cpu(capsys):
    train.main(["--engine", "--device", "cpu", "--rounds", "2",
                "--seq-len", "8", "--global-batch", "1", "--uplink-codec",
                "topk"])
    out = capsys.readouterr().out
    assert "engine mesh {} clients/round=4 federation=8" in out
    assert "done: 2 rounds" in out and "ef_store=device" in out
    assert "round    2" in out


def test_train_lm_federated_torch_example_runs_on_the_cpu(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_lm_federated_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_twin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--rounds", "2", "--seq-len", "16",
                    "--local-steps", "2", "--local-batch", "2",
                    "--eval-every", "1"])
    out = capsys.readouterr().out
    assert res.comm.rounds == 2 and "final eval" in out
    assert all(np.isfinite(h["local_loss"]) for h in res.comm.history)
