"""The rest of the paper's main path on the port, against the JAX package on
the CPU: the local trainer's step count, the fig. 6 new-client probe
(``repro_torch.fl.newclient``), FedProx (``repro_torch.contrib``) and the
two example twins (``examples/*_torch.py``).

Tolerances are slice 1's (``test_torch_rounds.py``): trained parameters
within rtol 1e-4 / atol 1e-5 of JAX's, accuracies within one example.
"""
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rounds import NARROW, _check, _run_both

from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.core import make_local_trainer as j_make_local_trainer
from repro.data.federated import FederatedDataset as JFD
from repro.data.partition import artificial_noniid_partition as j_noniid
from repro.data.partition import permuted_partition as j_permuted
from repro.data.synth import class_images as j_class_images
from repro.fl.api import FederatedTrainer as JTrainer
from repro.fl.api import make_algorithm as j_make_algorithm
from repro.fl.newclient import newclient_convergence as j_newclient
from repro.fl.server import run_federated as j_run_federated
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import CNN_MNIST as T_MNIST
from repro_torch.configs import FLConfig as TFL
from repro_torch.core import make_local_trainer
from repro_torch.fl import newclient as t_newclient_mod
from repro_torch.fl.api import make_algorithm
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.models import make_bundle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _bundles(cnn=tuple(NARROW.items())):
    cnn = dict(cnn)
    return (j_make_bundle(dataclasses.replace(J_MNIST, **cnn)),
            make_bundle(dataclasses.replace(T_MNIST, **cnn)))


def _assert_trees_close(got_torch, want_jax):
    got = state_to_numpy(got_torch)
    want = jax.tree.map(np.asarray, want_jax)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the local trainer iterates over its batches' leading dim
# --------------------------------------------------------------------------

def test_local_train_takes_every_batch():
    """A trainer built with ``local_steps=2`` and handed 5 batches takes 5
    steps, as JAX's ``lax.scan`` over the leading dim does (the parent
    sliced ``range(fl.local_steps)``: 2 steps)."""
    jb, tb = _bundles()
    fl_kw = dict(algorithm="fedavg", local_steps=2, local_batch=8, lr=0.05)
    s0 = jax.tree.map(np.asarray, j_init_global_state(
        jb, JFL(**fl_kw), jax.random.PRNGKey(0)))
    x, y = j_class_images(4, shape=NARROW["input_shape"], seed=0,
                          template_seed=0)
    idx = np.random.default_rng(0).permutation(len(x))[:40].reshape(5, 8)
    batches = {"x": x[idx], "y": y[idx]}
    jt, _ = j_make_local_trainer(jb, JFL(**fl_kw))(
        s0["model"], {}, {k: jnp.asarray(v) for k, v in batches.items()},
        jnp.float32(0.05))
    steps = []
    tfl = TFL(**fl_kw)
    trainer = make_local_trainer(tb, tfl)
    algo = make_algorithm(tfl.algorithm)
    real_loss = algo.local_loss

    def counting_loss(*a, **kw):
        steps.append(1)
        return real_loss(*a, **kw)

    algo.local_loss = counting_loss
    try:
        tt, loss = trainer(state_from_numpy(s0)["model"], {},
                           {k: torch.from_numpy(v)
                            for k, v in batches.items()}, 0.05)
    finally:
        del algo.local_loss
    assert len(steps) == 5
    _assert_trees_close(tt["model"], jt["model"])


# --------------------------------------------------------------------------
# fig. 6: the new-client probe
# --------------------------------------------------------------------------

def _j_probe_state(jb, jfl, state, client, *, epochs, batch, lr, seed):
    """JAX's probe loop (``repro/fl/newclient.py``), returning the trained
    state JAX's function keeps to itself."""
    rng = np.random.default_rng(seed)
    algo = j_make_algorithm(jfl.algorithm)
    trainer = jax.jit(j_make_local_trainer(jb, jfl))
    n = len(client["x"])
    steps = max(n // batch, 1)
    state = dict(state)
    for _ in range(epochs):
        idx = rng.permutation(n)[: steps * batch].reshape(steps, batch)
        tr, _ = trainer(state["model"], algo.extra_from_state(state),
                        {k: jnp.asarray(v[idx]) for k, v in client.items()},
                        jnp.float32(lr))
        state = {k: tr[k] for k in ("model",) + algo.extra_state}
    return state


@pytest.mark.parametrize("algorithm,op", [("fedavg", "multi"),
                                          ("fedfusion", "conv")])
def test_newclient_convergence_matches_jax(algorithm, op):
    """Two epochs from the same state on a permuted newcomer of 60
    examples (7 steps of 8 an epoch, not ``fl.local_steps``): the trained
    state within rtol 1e-4, each epoch's accuracy within one example.
    ``newclient_epochs`` yields the states and the accuracies
    ``newclient_convergence`` returns."""
    jb, tb = _bundles()
    fl_kw = dict(algorithm=algorithm, fusion_op=op, local_steps=2,
                 local_batch=8, lr=0.06)
    jfl, tfl = JFL(**fl_kw), TFL(**fl_kw)
    x, y = j_class_images(6, shape=NARROW["input_shape"], seed=0,
                          template_seed=0)
    new = j_permuted(x, y, 1, seed=1234)[0]
    client = {"x": new["x"], "y": new["y"]}
    s0 = jax.tree.map(np.asarray, j_init_global_state(
        jb, jfl, jax.random.PRNGKey(3)))
    kw = dict(epochs=2, batch=8, lr=0.06, seed=5)
    want_acc = j_newclient(jb, jfl, s0, client, **kw)
    want_state = _j_probe_state(jb, jfl, s0, client, **kw)

    got_acc = t_newclient_mod.newclient_convergence(
        tb, tfl, state_from_numpy(s0), client, **kw)
    epochs = list(t_newclient_mod.newclient_epochs(
        tb, tfl, state_from_numpy(s0), client, **kw))
    assert len(got_acc) == 2 and [a for _, a in epochs] == got_acc
    for g, w in zip(got_acc, want_acc):
        assert abs(g - w) <= 1.0 / len(client["x"]) + 1e-6
    _assert_trees_close(epochs[-1][0], want_state)


# --------------------------------------------------------------------------
# FedProx: the contrib plugin against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
def test_fedprox_round_matches_jax(mode):
    fl_kw = dict(algorithm="fedprox", prox_mu=0.5, clients_per_round=2,
                 local_steps=2, local_batch=8, lr=0.05)
    assert TFL().prox_mu == JFL().prox_mu == 0.01
    _check(*_run_both(fl_kw, mode, rounds=2))


# --------------------------------------------------------------------------
# the example twins
# --------------------------------------------------------------------------

def _example(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = dict(shape=(12, 12, 1), conv_channels=(4, 8), fc_units=(16,),
             n_per_class=6, n_test_per_class=4, n_clients=4,
             clients_per_round=2, local_steps=2, local_batch=8)


def _j_init(jb):
    return lambda fl: state_from_numpy(jax.tree.map(
        np.asarray, j_init_global_state(jb, JFL(**{
            f.name: getattr(fl, f.name) for f in dataclasses.fields(fl)}),
            jax.random.PRNGKey(0))))


def test_quickstart_twin_matches_jax():
    """``examples/quickstart_torch.py``'s ``main`` at a reduced size against
    ``examples/quickstart.py``'s steps through the JAX package (one
    dataset shared by the algorithms, as there), from JAX's initial
    states."""
    algos = (("fedavg", "multi"), ("fedfusion", "conv"))
    jb, _ = _bundles((("input_shape", (12, 12, 1)),
                      ("conv_channels", (4, 8)), ("fc_units", (16,)),
                      ("dropout", 0.0)))
    got = _example("quickstart_torch.py").main(
        3, device="cpu", algorithms=algos, lr=0.1, init_state=_j_init(jb),
        verbose=False, **SMALL)
    x, y = j_class_images(6, n_classes=10, shape=(12, 12, 1), seed=0,
                          noise=0.2, template_seed=0)
    xt, yt = j_class_images(4, n_classes=10, shape=(12, 12, 1), seed=1,
                            noise=0.2, template_seed=0)
    data = JFD(j_noniid(x, y, 4, shards_per_client=2), {"x": xt, "y": yt})
    for algo, op in algos:
        fl = JFL(algorithm=algo, fusion_op=op, clients_per_round=2,
                 local_steps=2, local_batch=8, lr=0.1, mmd_lambda=0.1)
        res = JTrainer(jb, fl, data).fit(3)
        to_target, acc, bytes_up, state = got[algo]
        assert bytes_up == res.comm.bytes_up
        assert abs(acc - res.comm.history[-1]["acc"]) <= 1 / 40 + 1e-6
        _assert_trees_close(state, res.global_state)


def test_newclient_twin_matches_jax():
    """``examples/newclient_generalization_torch.py``'s ``main`` at a
    reduced size against ``examples/newclient_generalization.py``'s steps
    through the JAX package, from JAX's initial states."""
    variants = (("fedavg", "multi"), ("fedfusion", "conv"))
    jb, _ = _bundles((("input_shape", (12, 12, 1)),
                      ("conv_channels", (4, 8)), ("fc_units", (16,)),
                      ("dropout", 0.0)))
    got = _example("newclient_generalization_torch.py").main(
        2, 2, device="cpu", variants=variants, init_state=_j_init(jb),
        verbose=False, **SMALL)
    x, y = j_class_images(6, n_classes=10, shape=(12, 12, 1), seed=0,
                          noise=0.2, template_seed=0)
    xt, yt = j_class_images(4, n_classes=10, shape=(12, 12, 1), seed=1,
                            noise=0.2, template_seed=0)
    new = j_permuted(x, y, 1, seed=777)[0]
    for algo, op in variants:
        fl = JFL(algorithm=algo, fusion_op=op, clients_per_round=2,
                 local_steps=2, local_batch=8, lr=0.08, lr_decay=0.99)
        res = j_run_federated(jb, fl, JFD(j_permuted(x, y, 4),
                                          {"x": xt, "y": yt}), rounds=2)
        want = j_newclient(jb, fl, res.global_state,
                           {"x": new["x"], "y": new["y"]}, epochs=2,
                           batch=8, lr=0.08)
        tag = op if algo == "fedfusion" else "fedavg"
        assert len(got[tag]) == 2
        for g, w in zip(got[tag], want):
            assert abs(g - w) <= 1.0 / len(new["x"]) + 1e-6
