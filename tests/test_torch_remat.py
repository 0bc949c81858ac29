"""Activation checkpointing (``cfg.remat``) in the port's transformer, on
the CPU, at reduced size: smollm-135m, granite-moe-1b-a400m, gemma3-1b,
mamba2-130m and recurrentgemma-9b (five layers: one cycle of RG-LRU,
RG-LRU, local attention and a tail of two RG-LRU layers, which are not
checkpointed).

* ``remat="attn"`` and ``"layer"`` give ``"none"``'s loss and gradients,
  with JAX's own bound (``tests/test_perf_knobs.py``: the loss rtol 1e-6,
  the gradients atol 1e-5 / rtol 1e-4), with plain attention and with
  K8a–K8c (their plain versions here);
* they match the JAX package's runs of the same ``remat`` (rtol 1e-4, an
  atol of 1e-4 of the gradients' scale, as ``tests/test_torch_recurrent.py``);
* checkpointing takes effect: the tensors autograd keeps for the backward
  shrink, and under ``attn_impl="pallas"`` K8a runs once more per
  checkpointed attention layer in a step (the backward's recomputation),
  never in the tail;
* the LM engine with ``remat="layer"`` equals the port's reference loop
  with it, and ``remat="none"``'s within the bound above.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import hybrid_pattern as j_hybrid_pattern
from repro.models import transformer as jtfm
from repro_torch.configs import FLConfig, get_config
from repro_torch.data import FederatedDataset, source_partition, token_stream
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels import flash_attn
from repro_torch.models import make_bundle
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "gemma3-1b", "mamba2-130m",
         "recurrentgemma-9b")
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the test workers share the
    machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _changes(name):
    if name == "recurrentgemma-9b":
        return dict(n_layers=5, block_pattern=j_hybrid_pattern(5))
    return {}


@functools.cache
def _model(name):
    """(JAX cfg, port cfg, JAX params, tokens, labels): the reduced
    configs, the port's seeded init carried across to JAX's layout
    (``tests/test_torch_recurrent.py`` carries JAX's init the other way;
    a JAX init here would add a compile per family)."""
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), **_changes(name))
    tcfg = dataclasses.replace(get_config(name).reduced(), **_changes(name))
    jparams = state_to_numpy(tfm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tokens, labels


def _loss_and_grads(cfg, params, tokens, labels):
    """JAX's ``tests/test_perf_knobs.py`` loss: the mean token
    cross-entropy of the logits (no aux)."""
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    lg = tfm.forward_seq(cfg, p, {"tokens": torch.from_numpy(tokens)
                                  .long()})["logits"]
    loss = torch.mean(torch.logsumexp(lg, -1) - lg.gather(
        -1, torch.from_numpy(labels).long()[..., None])[..., 0])
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, p)


def _jax_loss_and_grads(cfg, params, tokens, labels):
    def loss(p):
        lg = jtfm.forward_seq(cfg, p, {"tokens": tokens})["logits"]
        lz = jax.nn.logsumexp(lg, -1)
        oh = jax.nn.one_hot(labels, lg.shape[-1])
        return jnp.mean(lz - jnp.sum(lg * oh, -1))
    return jax.jit(jax.value_and_grad(loss))(params)


def _same(g0, g1):
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("remat,impl", [("attn", "jnp"), ("layer", "jnp"),
                                        ("layer", "pallas")])
@pytest.mark.parametrize("name", ARCHS)
def test_remat_preserves_loss_and_grads(name, remat, impl):
    _, tcfg, jparams, tokens, labels = _model(name)
    base = dataclasses.replace(tcfg, attn_impl=impl)
    params = state_from_numpy(jparams)
    l0, g0 = _loss_and_grads(base, params, tokens, labels)
    l1, g1 = _loss_and_grads(dataclasses.replace(base, remat=remat), params,
                             tokens, labels)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    _same(g0, g1)


JAX_CASES = [(name, "layer") for name in ARCHS] + [
    ("recurrentgemma-9b", "attn")]


@pytest.mark.parametrize("name,remat", JAX_CASES,
                         ids=["-".join(c) for c in JAX_CASES])
def test_remat_matches_jax_remat(name, remat):
    jcfg, tcfg, jparams, tokens, labels = _model(name)
    jl, jg = _jax_loss_and_grads(dataclasses.replace(jcfg, remat=remat),
                                 jparams, tokens, labels)
    tl, tg = _loss_and_grads(dataclasses.replace(tcfg, remat=remat),
                             state_from_numpy(jparams), tokens, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-5)
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), tg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-3))


def _saved_bytes(cfg, params, tokens):
    """Bytes of the tensors autograd keeps for the backward of a forward
    (each storage counted once)."""
    kept = []

    def pack(t):
        kept.append(t)
        return t

    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tfm.forward_seq(cfg, p, {"tokens": torch.from_numpy(tokens).long()},
                        want_logits=False)
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in kept}.values())


@pytest.mark.parametrize("name", ARCHS)
def test_remat_keeps_fewer_activations(name):
    """``"layer"`` keeps less than ``"none"`` (the checkpointed cycles keep
    their inputs only); ``"attn"`` keeps less than ``"none"`` where the
    pattern has attention; with K8a (``"pallas"``) ``"attn"`` changes
    nothing, as in the JAX package."""
    _, tcfg, jparams, tokens, _ = _model(name)
    params = state_from_numpy(jparams)
    got = {(impl, r): _saved_bytes(dataclasses.replace(
        tcfg, attn_impl=impl, remat=r), params, tokens)
        for impl in ("jnp", "pallas") for r in ("none", "attn", "layer")}
    for impl in ("jnp", "pallas"):
        assert got[impl, "layer"] < got[impl, "none"]
    has_attn = any(k.startswith("attn") for k in tcfg.block_pattern)
    assert (got["jnp", "attn"] < got["jnp", "none"]) == has_attn
    assert got["pallas", "attn"] == got["pallas", "none"]


@pytest.mark.parametrize("name", ["gemma3-1b", "recurrentgemma-9b"])
def test_remat_layer_reruns_k8a_in_the_backward(name, monkeypatch):
    """K8a's forward (its plain version on the CPU) per training step: once
    per attention layer, and once more per checkpointed one under
    ``remat="layer"`` (recurrentgemma-9b's attention is in its cycle; the
    tail has none)."""
    calls = []
    real = flash_attn.flash_fwd
    monkeypatch.setattr(flash_attn, "flash_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tcfg, jparams, tokens, labels = _model(name)
    n_attn = sum(k.startswith("attn") for k in tcfg.block_pattern)
    for remat, want in (("none", n_attn), ("layer", 2 * n_attn)):
        calls.clear()
        _loss_and_grads(dataclasses.replace(tcfg, attn_impl="pallas",
                                            remat=remat),
                        state_from_numpy(jparams), tokens, labels)
        assert len(calls) == want, (remat, len(calls))


def test_remat_is_off_without_autograd():
    """Eval and serving run no checkpoint: bit-equal logits, and the
    prefill cache as before."""
    _, tcfg, jparams, tokens, _ = _model("recurrentgemma-9b")
    params = state_from_numpy(jparams)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    with torch.no_grad():
        outs = [tfm.forward_seq(dataclasses.replace(tcfg, remat=r), params,
                                batch, want_cache=True)
                for r in ("none", "layer")]
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m"])
def test_lm_engine_with_remat_equals_its_reference(name):
    """FedFusion-conv, 2 of 4 clients, 2 rounds in one chunk: the engine
    with ``remat="layer"`` equal to the reference loop with it; both
    within the bound of ``remat="none"``'s state."""
    tcfg = dataclasses.replace(get_config(name).reduced(),
                               attn_impl="pallas", vocab_size=64)
    toks, src = token_stream(64, S, vocab=64, n_sources=4, seed=0)
    test, _ = token_stream(8, S, vocab=64, n_sources=4, seed=1)

    def data():
        return FederatedDataset(source_partition(toks, src, 4),
                                {"tokens": test}, seed=0)

    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  clients_per_round=2, local_steps=2, local_batch=2,
                  lr=0.05)
    kw = dict(rounds=2, seed=1, eval_every=2, eval_examples=8, device="cpu")
    runs = {}
    for remat in ("none", "layer"):
        bundle = make_bundle(dataclasses.replace(tcfg, remat=remat))
        runs[remat] = run_federated(bundle, fl, data(), superstep_rounds=2,
                                    **kw)
    ref = run_federated_reference(make_bundle(dataclasses.replace(
        tcfg, remat="layer")), fl, data(), **kw)
    for a, b in zip(tree_leaves(runs["layer"].global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b)
    assert runs["layer"].comm.history == ref.comm.history
    _same(runs["none"].global_state, runs["layer"].global_state)
