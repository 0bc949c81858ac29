"""The port's MoE family against the JAX package, on the CPU:
``models/moe.py`` (``moe_apply`` at a capacity that drops tokens, at full
capacity, with a dense residual, with ``shard_capacity`` on and off, with
``silu`` and ``gelu``; its aux loss; its gradients against ``jax.grad``;
``moe_reference``), the one-rank ``moe_dispatch.moe_apply_a2a``, and the
MoE configs ``granite-moe-1b-a400m`` and ``arctic-480b`` (dense residual,
top-2 of 4 reduced): ``forward_seq`` logits and aux, 8 decode steps over
the cache against JAX's ``decode_step``, ``param_struct`` at full size
against JAX's ``eval_shape``, and one ``launch.train`` FedAvg round on
reduced granite against JAX's ``build_train_step`` round function.

Tolerances: outputs and logits rtol 1e-4 with an atol of 1e-4 of their
scale (XLA and PyTorch sum the products, and the experts' results into the
tokens, in other orders); parameters and losses rtol 1e-4 / atol 1e-5, as
``tests/test_torch_lm_training.py``.  Outputs are compared, never the
capacity pick's indices: its ties at zero may come in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.base import InputShape as JShape
from repro.core import init_global_state as j_init_global_state
from repro.data.partition import source_partition as j_source_partition
from repro.data.synth import token_stream as j_token_stream
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.registry import make_bundle as j_make_bundle
from repro.optim import exp_decay_per_round as j_decay
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import steps, train
from repro_torch.models import moe, moe_dispatch
from repro_torch.models import transformer as tfm
from repro_torch.parallel import ModelParallel, TensorParallel
from repro_torch.tree import tree_map, tree_with_path

RTOL, ATOL = 1e-4, 1e-5
D, F_, E, K = 16, 32, 8, 2
NAMES = ("granite-moe-1b-a400m", "arctic-480b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the test workers share the
    machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def _layer(act, dense_residual=False, seed=0):
    """JAX's ``moe_init`` leaves (numpy), the port's copy, and x [2, 12, d]
    ~ N(1, 1): 24 tokens, of which at capacity 1.25 each expert keeps
    int(2 * 24 / 8 * 1.25) = 7; the common offset skews the routing, so the
    favoured experts drop tokens."""
    jp = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), D, E, F_, act,
        dense_residual=dense_residual, d_ff=24))
    x = 1.0 + np.random.default_rng(seed + 1).standard_normal(
        (2, 12, D)).astype(np.float32)
    return jp, state_from_numpy(jp), x


CASES = {"capacity": {}, "full": {"full_capacity": True},
         "dense_residual": {"dense_residual": True},
         "shard_capacity": {"shard_capacity": True}}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_apply_matches_jax(act, case):
    kw = dict(CASES[case], top_k=K, act=act)
    jp, tp, x = _layer(act, kw.get("dense_residual", False))
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), **kw)
    out, aux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    if case == "capacity":       # tokens were dropped: not the dense mix
        ref = jmoe.moe_reference(jp, jnp.asarray(x), top_k=K, act=act)
        assert np.abs(np.asarray(jout) - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("dense_residual", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_reference_and_full_capacity_match_jax_reference(
        act, dense_residual):
    jp, tp, x = _layer(act, dense_residual)
    want = jmoe.moe_reference(jp, jnp.asarray(x), top_k=K, act=act,
                              dense_residual=dense_residual)
    _close(moe.moe_reference(tp, torch.from_numpy(x), top_k=K, act=act,
                             dense_residual=dense_residual), want)
    out, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=K, act=act,
                           full_capacity=True,
                           dense_residual=dense_residual)
    _close(out, want)


def test_shard_capacity_changes_no_value():
    _, tp, x = _layer("silu")
    a = moe.moe_apply(tp, torch.from_numpy(x), top_k=K, act="silu")
    b = moe.moe_apply(tp, torch.from_numpy(x), top_k=K, act="silu",
                      shard_capacity=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("act,dense_residual", [("silu", False),
                                                ("gelu", True)])
def test_moe_apply_gradients_match_jax_grad(act, dense_residual):
    """d/d(params, x) of sum(out * g) + 0.3 aux at capacity 1.25."""
    jp, _, x = _layer(act, dense_residual)
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    kw = dict(top_k=K, act=act, dense_residual=dense_residual)

    def jloss(p, xx):
        out, aux = jmoe.moe_apply(p, xx, **kw)
        return jnp.sum(out * g) + 0.3 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), jp)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_apply(tp, tx, **kw)
    (torch.sum(out * torch.from_numpy(g)) + 0.3 * aux).backward()
    _close(tx.grad, jgx)
    for want, got in zip(jax.tree.leaves(jgp), jax.tree.leaves(
            jax.tree.map(lambda t: t.grad.numpy(), tp,
                         is_leaf=lambda t: isinstance(t, torch.Tensor)))):
        _close(got, want)


def test_a2a_on_one_rank_is_the_gather_dispatch():
    """One rank: the all-to-all is the identity and the source's capacity
    the global one, so the output is ``moe_apply``'s bit for bit."""
    _, tp, x = _layer("silu", dense_residual=True)
    kw = dict(top_k=K, act="silu", dense_residual=True)
    a = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    b = moe_dispatch.moe_apply_a2a(tp, torch.from_numpy(x), None, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="experts"):
        moe_dispatch.moe_apply_a2a(
            dict(tp, w1=tp["w1"][:4]), torch.from_numpy(x), None, **kw)


def test_a2a_dispatch_in_the_transformer_needs_a_parallel_context():
    cfg = dataclasses.replace(get_config(NAMES[0]).reduced(),
                              moe_dispatch="a2a")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="a2a"):
        tfm.forward_seq(cfg, params, toks)
    one = TensorParallel(ModelParallel(), {"model": tree_map(
        lambda t: (None,) * t.dim(), params)})
    with torch.no_grad():
        got = tfm.forward_seq(cfg, params, toks, tp=one)
        want = tfm.forward_seq(dataclasses.replace(cfg,
                                                   moe_dispatch="gather"),
                               params, toks)
    assert torch.equal(got["logits"], want["logits"])


# --------------------------------------------------------------------------
# the MoE configs through the transformer
# --------------------------------------------------------------------------

S, GEN, B = 40, 8, 2


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(port cfg, JAX cfg, port params, JAX params, tokens [B, S + GEN])."""
    jcfg = dataclasses.replace(J_ARCHS[request.param].reduced(),
                               attn_impl="jnp")
    tcfg = dataclasses.replace(get_config(request.param).reduced(),
                               attn_impl="pallas")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = state_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, S + GEN)).astype(np.int32)
    return tcfg, jcfg, tparams, jparams, tokens


def test_forward_seq_logits_and_aux_match_jax(model):
    tcfg, jcfg, tparams, jparams, tokens = model
    jout = jtfm.forward_seq(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        out = tfm.forward_seq(tcfg, tparams,
                              {"tokens": torch.from_numpy(tokens).long()})
    _close(out["logits"], jout["logits"])
    assert float(out["aux"]) > 0
    np.testing.assert_allclose(float(out["aux"]), float(jout["aux"]),
                               rtol=RTOL, atol=ATOL)


def test_decode_steps_match_jax_decode_step(model):
    """Prefill S tokens, then 8 decode steps fed the drawn tokens, each
    step's logits and the final cache against JAX's."""
    tcfg, jcfg, tparams, jparams, tokens = model
    jout = jtfm.forward_seq(jcfg, jparams,
                            {"tokens": jnp.asarray(tokens[:, :S])},
                            want_cache=True, max_cache_len=S + GEN)
    jcache = jout["cache"]
    with torch.no_grad():
        out = tfm.forward_seq(tcfg, tparams,
                              {"tokens": torch.from_numpy(tokens[:, :S])
                               .long()}, want_cache=True,
                              max_cache_len=S + GEN)
        cache = out["cache"]
        _close(out["logits"], jout["logits"])
        jstep = jax.jit(lambda p, t, c, pos: jtfm.decode_step(jcfg, p, t, c,
                                                              pos))
        for i in range(GEN):
            t = tokens[:, S + i:S + i + 1]
            jl, jcache = jstep(jparams, jnp.asarray(t), jcache,
                               jnp.int32(S + i))
            tl, cache = tfm.decode_step(tcfg, tparams,
                                        torch.from_numpy(t).long(), cache,
                                        S + i)
            _close(tl, jl)
    for a, b in zip(jax.tree.leaves(state_to_numpy(cache)),
                    jax.tree.leaves(jcache)):
        _close(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_param_struct_at_full_size_matches_jax_eval_shape(name):
    """Nothing allocated on either side: arctic-480b's 480 B parameters
    as shapes only."""
    js = jax.eval_shape(lambda k: jtfm.init_params(J_ARCHS[name], k),
                        jax.random.PRNGKey(0))
    want = {jtu.keystr(p): tuple(l.shape)
            for p, l in jtu.tree_flatten_with_path(js)[0]}
    got = {}
    tree_with_path(lambda p, s: got.__setitem__(
        "".join(f"[{k!r}]" for k in p), tuple(s)),
        steps.param_struct(get_config(name)))
    assert got == want


def test_launch_train_fedavg_round_on_granite_matches_jax_round_fn():
    """``launch.train.train_rounds`` on reduced granite-moe-1b (top-4 of 4
    experts, attn_impl "pallas" on both sides) against JAX's
    ``build_train_step`` round function, 1 FedAvg round from the same
    state on the same numpy draws: the loss carries AUX_WEIGHT * aux."""
    name = NAMES[0]
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), attn_impl="pallas",
                               vocab_size=256)
    tcfg = dataclasses.replace(get_config(name).reduced(),
                               attn_impl="pallas", vocab_size=256)
    fl_kw = dict(algorithm="fedavg", local_steps=2, lr=0.05)
    j_round = jax.jit(j_build_train_step(
        jcfg, JFL(**fl_kw), JShape("custom_train", 16, 4, "train"),
        jax.make_mesh((1, 1), ("data", "model")), dtype=jnp.float32)[0])
    s0 = j_init_global_state(j_make_bundle(jcfg), JFL(**fl_kw),
                             jax.random.PRNGKey(0))
    toks, src = j_token_stream(64, 16, vocab=jcfg.vocab_size, n_sources=1)
    pool = j_source_partition(toks, src, 1)[0]["tokens"]
    arr = pool[np.random.default_rng(0).choice(len(pool), (2, 4))][None]
    state, metrics = j_round(s0, {"tokens": jnp.asarray(arr[..., :-1]),
                                  "labels": jnp.asarray(arr[..., 1:])},
                             jnp.ones((1,)), j_decay(0.05, 0.995)(0))
    got, records = train.train_rounds(
        tcfg, FLConfig(**fl_kw), InputShape("custom_train", 16, 4, "train"),
        rounds=1, device="cpu",
        global_state=state_from_numpy(jax.tree.map(np.asarray, s0)),
        log=None)
    got, want = state_to_numpy(got), jax.tree.map(np.asarray, state)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(records[0]["loss"],
                               float(metrics["local_loss"]), rtol=RTOL,
                               atol=ATOL)
