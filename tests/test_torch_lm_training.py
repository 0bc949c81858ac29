"""Federated LM training in the port against the JAX package, on the CPU:
the token data (``token_stream``, ``source_partition``, the loader's token
batches), the transformer bundle's loss and gradients, the reference
server loop and the ``launch.train`` round, on ``smollm-135m.reduced()``
and ``gemma3-1b.reduced()`` from the same (converted) JAX parameters; the
loss and gradients also on ``stablelm-3b.reduced()`` and
``h2o-danube-3-4b.reduced()`` at their head dims, 80 and 120.

The data streams are numpy on both sides and must be equal.  Tolerances:
float32.  XLA and PyTorch sum the products in other orders (the JAX
``attn_impl="pallas"`` path runs the Pallas kernels in interpret mode, the
port the plain K8a / K8b / K8c versions); over two layers the loss and the
gradients agree to ~1e-6 of their scale, and over 2 rounds of SGD the
parameters stay well inside rtol 1e-4 / atol 1e-5, as slice 1 held the
CNNs.  Losses are held to rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import reduced

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.base import InputShape as JShape
from repro.core import init_global_state as j_init_global_state
from repro.core.losses import cross_entropy as j_cross_entropy
from repro.data.federated import FederatedDataset as JFD
from repro.data.partition import source_partition as j_source_partition
from repro.data.synth import token_stream as j_token_stream
from repro.fl.server import run_federated_reference as j_run
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.registry import make_bundle as j_make_bundle
from repro.optim import exp_decay_per_round as j_decay
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.core.losses import cross_entropy
from repro_torch.data import FederatedDataset, source_partition, token_stream
from repro_torch.fl.server import run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import specs, steps, train
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-5
FL_KW = dict(clients_per_round=2, local_steps=2, local_batch=2, lr=0.05,
             fusion_op="conv")


def _cfgs(name, impl="jnp", vocab=256):
    return (reduced(J_ARCHS[name], attn_impl=impl, vocab_size=vocab),
            reduced(get_config(name), attn_impl=impl, vocab_size=vocab))


def _close_trees(got, want):
    got, want = state_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# token data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,vocab,sources,seed", [(40, 17, 256, 5, 0),
                                                    (12, 64, 49_152, 3, 1)])
def test_token_stream_and_source_partition_match_jax(n, S, vocab, sources,
                                                     seed):
    toks, src = token_stream(n, S, vocab=vocab, n_sources=sources, seed=seed)
    jt, js = j_token_stream(n, S, vocab=vocab, n_sources=sources, seed=seed)
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_array_equal(src, js)
    assert toks.dtype == jt.dtype and src.dtype == js.dtype
    for spc in (1, 2):
        got = source_partition(toks, src, 4, sources_per_client=spc)
        want = j_source_partition(jt, js, 4, sources_per_client=spc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"tokens"}
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_token_batches_match_jax():
    toks, src = token_stream(60, 12, vocab=300, n_sources=6)
    test, _ = token_stream(20, 12, vocab=300, n_sources=6, seed=1)
    parts = source_partition(toks, src, 6)
    port, ref = (FD(parts, {"tokens": test}, seed=3)
                 for FD in (FederatedDataset, JFD))
    np.testing.assert_array_equal(port.client_sizes(), ref.client_sizes())
    for _ in range(2):
        cids = port.sample_clients(3)
        np.testing.assert_array_equal(cids, ref.sample_clients(3))
        (got, gs), (want, ws) = (d.round_batch(cids, 2, 4)
                                 for d in (port, ref))
        np.testing.assert_array_equal(gs, ws)
        assert set(got) == set(want) == {"tokens", "labels"}
        assert got["tokens"].shape == (3, 2, 4, 12)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["labels"][..., :-1],
                                      got["tokens"][..., 1:])
    for n in (None, 5):
        got, want = port.test_batch(n), ref.test_batch(n)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    # resume replays the same stream
    port.skip_round_sampling(1, 3, 2, 4)
    ref.skip_round_sampling(1, 3, 2, 4)
    np.testing.assert_array_equal(port.sample_clients(3),
                                  ref.sample_clients(3))


# --------------------------------------------------------------------------
# the transformer bundle: loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,impl", [
    (name, impl) for impl in ("jnp", "pallas")
    for name in ("smollm-135m", "gemma3-1b")] + [
    ("stablelm-3b", "pallas"), ("h2o-danube-3-4b", "pallas")])
def test_lm_bundle_loss_and_grads_match_jax(name, impl):
    """S = 96 is longer than the reduced window (64), so gemma3's and
    h2o-danube-3-4b's local layers mask by window in the forward and the
    backward."""
    jcfg, tcfg = _cfgs(name, impl, vocab=512)
    jb, tb = j_make_bundle(jcfg), make_bundle(tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, size=(2, 97))
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32),
              "labels": jnp.asarray(tokens[:, 1:], jnp.int32)}
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in jbatch.items()}

    def j_loss(p):
        return j_cross_entropy(jb.apply(p, jbatch)["logits"],
                               jb.labels(jbatch))

    want, want_g = jax.value_and_grad(j_loss)(jparams)
    params = state_from_numpy(jax.tree.map(np.asarray, jparams))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = cross_entropy(tb.apply(params, tbatch)["logits"],
                         tb.labels(tbatch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # the pooled features and the extract / head split of the bundle
    feats, aux = tb.extract(params, tbatch)
    assert feats.shape == (2, 96, tcfg.d_model) and float(aux) == 0.0
    assert tb.pool(feats).shape == (2, tcfg.d_model)


# --------------------------------------------------------------------------
# the federated loops
# --------------------------------------------------------------------------

def _token_fed(vocab, S=16):
    toks, src = token_stream(48, S, vocab=vocab, n_sources=8)
    test, _ = token_stream(6, S, vocab=vocab, n_sources=8, seed=1)
    return source_partition(toks, src, 4), {"tokens": test}


@pytest.mark.parametrize("name,algorithm", [
    ("smollm-135m", "fedavg"), ("smollm-135m", "fedmmd"),
    ("gemma3-1b", "fedfusion"), ("gemma3-1b", "fedl2")])
def test_reference_loop_matches_jax(name, algorithm):
    """JAX trains with ``attn_impl="jnp"``, the port with ``"pallas"`` (the
    path the card runs: K8a / K8b / K8c, here their plain versions); both
    compute the same attention.  Eval on the 6 test sequences: next-token
    accuracy and CE over every position."""
    jcfg, tcfg = _cfgs(name)
    tcfg = dataclasses.replace(tcfg, attn_impl="pallas")
    jb, tb = j_make_bundle(jcfg), make_bundle(tcfg)
    parts, test = _token_fed(jcfg.vocab_size)
    fl_kw = dict(FL_KW, algorithm=algorithm)
    jres = j_run(jb, JFL(**fl_kw), JFD(parts, test, seed=0), rounds=2,
                 seed=1, eval_examples=8)
    s0 = jax.tree.map(np.asarray, j_init_global_state(
        jb, JFL(**fl_kw), jax.random.PRNGKey(1)))
    tres = run_federated_reference(
        tb, FLConfig(**fl_kw), FederatedDataset(parts, test, seed=0),
        rounds=2, eval_examples=8, global_state=state_from_numpy(s0),
        device="cpu")
    _close_trees(tres.global_state, jres.global_state)
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        assert set(ht) == set(hj)
        for k in ("local_loss", "loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL, atol=ATOL)
        # next-token accuracy over 6 x 16 positions: one flip is 1/96
        assert abs(ht["acc"] - hj["acc"]) <= 1 / 96 + 1e-6
        assert ht["bytes_up"] == hj["bytes_up"]


@pytest.mark.parametrize("name,algorithm", [
    ("smollm-135m", "fedfusion"), ("gemma3-1b", "fedmmd")])
def test_launch_train_rounds_match_jax_round_fn(name, algorithm):
    """``launch.train.train_rounds`` against JAX's ``build_train_step``
    round function (jitted without shardings) on the same numpy batch
    draws and learning rates, 2 rounds, both with ``attn_impl="pallas"``
    (JAX's Pallas kernels in interpret mode)."""
    jcfg, tcfg = _cfgs(name, "pallas")
    fl_kw = dict(algorithm=algorithm, fusion_op="conv", local_steps=2,
                 lr=0.05)
    shape = InputShape("custom_train", 16, 4, "train")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    j_round = jax.jit(j_build_train_step(
        jcfg, JFL(**fl_kw), JShape("custom_train", 16, 4, "train"), mesh,
        dtype=jnp.float32)[0])
    jb = j_make_bundle(jcfg)
    s0 = j_init_global_state(jb, JFL(**fl_kw), jax.random.PRNGKey(0))
    plan = specs.fl_plan(tcfg, shape)
    assert (plan.n_clients, plan.local_steps, plan.client_batch) == (1, 2, 4)
    want_spec = ((1, 2, 4, 16), torch.int64)
    assert steps.build_train_step(tcfg, FLConfig(**fl_kw), shape)[1][1] == {
        "tokens": want_spec, "labels": want_spec}
    # the launcher's data draws, on the JAX side
    toks, src = j_token_stream(64, 16, vocab=jcfg.vocab_size, n_sources=1)
    pool = j_source_partition(toks, src, 1)[0]["tokens"]
    rng = np.random.default_rng(0)
    lr_at = j_decay(0.05, 0.995)
    state, losses = s0, []
    for r in range(2):
        arr = pool[rng.choice(len(pool), (2, 4))][None]
        batch = {"tokens": jnp.asarray(arr[..., :-1]),
                 "labels": jnp.asarray(arr[..., 1:])}
        state, metrics = j_round(state, batch, jnp.ones((1,)), lr_at(r))
        losses.append(float(metrics["local_loss"]))
    got, records = train.train_rounds(
        tcfg, FLConfig(**fl_kw), shape, rounds=2, device="cpu",
        global_state=state_from_numpy(jax.tree.map(np.asarray, s0)),
        log=None)
    _close_trees(got, state)
    np.testing.assert_allclose([r["loss"] for r in records], losses,
                               rtol=RTOL, atol=ATOL)
    assert [r["round"] for r in records] == [1, 2]


# --------------------------------------------------------------------------
# where the LM path runs
# --------------------------------------------------------------------------

def test_train_cli_runs_on_the_cpu_and_needs_a_card_by_default(capsys):
    train.main(["--device", "cpu", "--rounds", "2", "--seq-len", "16",
                "--global-batch", "2", "--algorithm", "fedmmd"])
    out = capsys.readouterr().out
    assert "attn_impl=pallas" in out and "round   2" in out and "done" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--rounds", "1"])


def test_lm_init_draws_on_the_generators_device():
    _, tcfg = _cfgs("gemma3-1b")
    from repro_torch.core import init_global_state
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv")
    state = init_global_state(make_bundle(tcfg), fl,
                              torch.Generator().manual_seed(0), device="cpu")
    assert state["fusion"]["w"].shape == (2 * tcfg.d_model, tcfg.d_model)
    again = init_global_state(make_bundle(tcfg), fl,
                              torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(again)))
