"""The port's recurrent families against the JAX package, on the CPU.

* ``models/ssd.py`` (Mamba-2 SSD) and ``models/rglru.py`` (RG-LRU): the
  sequence mode at several lengths (several chunks, an odd length that runs
  with chunk 1, one position), decode from a non-zero cache, the prefill
  cache (JAX's ``_ssd_seq_with_cache`` / ``_rglru_seq_cache``), and
  gradients against ``jax.grad``; the port's chunked SSD scan and its
  doubling RG-LRU scan against its own step-wise ``*_reference``.
* Reduced mamba2-130m (two SSD layers) and recurrentgemma-9b (five layers:
  one cycle of RG-LRU, RG-LRU, local attention and a tail of two RG-LRU
  layers): ``forward_seq`` logits and gradients, prefill and 6 decode
  steps with the final cache, one ``launch.train`` FedAvg round against
  JAX's round function, ``param_struct`` at full size against JAX's
  ``eval_shape``, the parameters carried across leaf by leaf, the eager
  ``DecodeGraph`` over two requests against ``greedy_decode``, the
  parameter and cache specs (``launch.sharding``) on four meshes against
  JAX's, the LM engine against the port's reference loop (exactly), and
  the refusals (a prompt shorter than the conv window; a ``model`` axis of
  more than one rank).

Tolerances: module outputs, caches and gradients rtol 1e-4 / atol 1e-5;
model logits and gradients rtol 1e-4 with an atol of 1e-4 of their scale
(XLA and PyTorch add the scans' and the products' terms in other orders);
parameters and losses of a round rtol 1e-4 / atol 1e-5, as
``tests/test_torch_lm_training.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.base import hybrid_pattern as j_hybrid_pattern
from repro.core import init_global_state as j_init_global_state
from repro.data.partition import source_partition as j_source_partition
from repro.data.synth import token_stream as j_token_stream
from repro.core.rounds import make_round_fn as j_make_round_fn
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro.models import transformer as jtfm
from repro.models.registry import make_bundle as j_make_bundle
from repro.optim import exp_decay_per_round as j_decay
from repro.launch import sharding as j_sh
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.data import FederatedDataset, source_partition, token_stream
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import serve, steps, train
from repro_torch.launch import sharding as t_sh
from repro_torch.models import make_bundle, rglru, ssd
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_with_path
from test_torch_tp_layouts import assert_specs_equal, meshes, to_port

RTOL, ATOL = 1e-4, 1e-5
D = 32
SSD_KW = dict(expand=2, d_state=8, head_dim=16, conv_width=4)
NAMES = ("mamba2-130m", "recurrentgemma-9b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (the test workers share the
    machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _eq(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close(got, want):
    """rtol 1e-4, atol 1e-4 of the expected values' scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ssd_params(seed=0):
    jp = jax.tree.map(np.asarray, jssd.ssd_init(jax.random.PRNGKey(seed), D,
                                                **SSD_KW))
    return jp, state_from_numpy(jp)


def _rglru_params(seed=0):
    jp = jax.tree.map(np.asarray, jrglru.rglru_init(
        jax.random.PRNGKey(seed), D, 24))
    return jp, state_from_numpy(jp)


def _tree_close(got, want, close=_eq):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(a, b)


# --------------------------------------------------------------------------
# the SSD block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(24, 8), (7, 8)])
def test_ssd_apply_matches_jax(S, chunk):
    """24 / 8: three chunks; 7: odd, chunk 1 (the halving rule at 20 / 16
    is held by the port's own reference below)."""
    jp, tp = _ssd_params()
    x = _x((2, S, D), 1)
    want = jax.jit(functools.partial(jssd.ssd_apply, chunk=chunk,
                                     **SSD_KW))(jp, jnp.asarray(x))
    with torch.no_grad():
        got = ssd.ssd_apply(tp, torch.from_numpy(x), chunk=chunk, **SSD_KW)
    _eq(got, want)


def test_ssd_decode_matches_jax():
    """Four steps from a non-zero state and conv window."""
    jp, tp = _ssd_params()
    jc = jssd.ssd_init_cache(2, D, **SSD_KW)
    jc = {"h": jnp.asarray(0.3 * _x(jc["h"].shape, 2)),
          "conv": jnp.asarray(_x(jc["conv"].shape, 3))}
    tc = state_from_numpy(jax.tree.map(np.asarray, jc))
    jstep = jax.jit(functools.partial(jssd.ssd_decode, **SSD_KW))
    for i in range(4):
        x = _x((2, 1, D), 10 + i)
        jy, jc = jstep(jp, jnp.asarray(x), jc)
        with torch.no_grad():
            ty, tc = ssd.ssd_decode(tp, torch.from_numpy(x), tc, **SSD_KW)
        _eq(ty, jy)
    _tree_close(state_to_numpy(tc), jc)


def test_ssd_prefill_cache_matches_jax():
    """The final state in JAX's closed form and the last three conv
    inputs, beside the sequence output (S = 3, the shortest prompt that
    fills the window: ``test_short_prompts_raise``)."""
    S = 24
    jcfg = dataclasses.replace(J_ARCHS["mamba2-130m"].reduced(), d_model=D,
                               ssm_state=8)
    jp, tp = _ssd_params()
    x = _x((2, S, D), 4)
    jy, jc = jax.jit(functools.partial(jtfm._ssd_seq_with_cache, jcfg))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        ty, tc = ssd.ssd_apply(tp, torch.from_numpy(x), chunk=8,
                               want_cache=True, **SSD_KW)
    _eq(ty, jy)
    _tree_close(state_to_numpy(tc), jc)


def test_ssd_gradients_match_jax_grad():
    """d/d(params, x) of sum(y * g) over three chunks: the upper
    triangle's mask before the exp keeps every gradient finite."""
    jp, _ = _ssd_params()
    x = _x((2, 24, D), 5)
    g = _x((2, 24, D), 6)

    def jloss(p, xx):
        return jnp.sum(jssd.ssd_apply(p, xx, chunk=8, **SSD_KW) * g)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), jp)
    tx = torch.tensor(x, requires_grad=True)
    (ssd.ssd_apply(tp, tx, chunk=8, **SSD_KW)
     * torch.from_numpy(g)).sum().backward()
    _eq(tx.grad, jgx)
    _tree_close(jax.tree.map(lambda t: t.grad.numpy(), tp,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                jgp)


@pytest.mark.parametrize("S,chunk", [(32, 8), (13, 4), (20, 16)])
def test_ssd_chunked_matches_its_reference(S, chunk):
    _, tp = _ssd_params(1)
    x = torch.from_numpy(_x((2, S, D), 7))
    with torch.no_grad():
        want = ssd.ssd_reference(tp, x, **SSD_KW)
        got = ssd.ssd_apply(tp, x, chunk=chunk, **SSD_KW)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the RG-LRU block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 33])
def test_rglru_apply_matches_jax(S):
    jp, tp = _rglru_params()
    x = _x((2, S, D), 1)
    want = jax.jit(jrglru.rglru_apply)(jp, jnp.asarray(x))
    with torch.no_grad():
        got = rglru.rglru_apply(tp, torch.from_numpy(x))
    _eq(got, want)


def test_rglru_decode_matches_jax():
    jp, tp = _rglru_params()
    jc = jrglru.rglru_init_cache(2, 24)
    jc = {"h": jnp.asarray(_x(jc["h"].shape, 2)),
          "conv": jnp.asarray(_x(jc["conv"].shape, 3))}
    tc = state_from_numpy(jax.tree.map(np.asarray, jc))
    jstep = jax.jit(jrglru.rglru_decode)
    for i in range(4):
        x = _x((2, 1, D), 10 + i)
        jy, jc = jstep(jp, jnp.asarray(x), jc)
        with torch.no_grad():
            ty, tc = rglru.rglru_decode(tp, torch.from_numpy(x), tc)
        _eq(ty, jy)
    _tree_close(state_to_numpy(tc), jc)


def test_rglru_prefill_cache_matches_jax():
    S = 17
    jp, tp = _rglru_params()
    x = _x((2, S, D), 4)
    jc = jax.jit(jtfm._rglru_seq_cache)(jp, jnp.asarray(x),
                                        jrglru.rglru_init_cache(2, 24))
    with torch.no_grad():
        ty, tc = rglru.rglru_apply(tp, torch.from_numpy(x), want_cache=True)
    _eq(ty, jax.jit(jrglru.rglru_apply)(jp, jnp.asarray(x)))
    _tree_close(state_to_numpy(tc), jc)


def test_rglru_gradients_match_jax_grad():
    jp, _ = _rglru_params()
    x = _x((2, 20, D), 5)
    g = _x((2, 20, D), 6)

    def jloss(p, xx):
        return jnp.sum(jrglru.rglru_apply(p, xx) * g)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), jp)
    tx = torch.tensor(x, requires_grad=True)
    (rglru.rglru_apply(tp, tx) * torch.from_numpy(g)).sum().backward()
    _eq(tx.grad, jgx)
    _tree_close(jax.tree.map(lambda t: t.grad.numpy(), tp,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                jgp)


@pytest.mark.parametrize("S", [1, 6, 31, 64])
def test_rglru_scan_matches_its_reference(S):
    _, tp = _rglru_params(1)
    x = torch.from_numpy(_x((2, S, D), 7))
    with torch.no_grad():
        torch.testing.assert_close(rglru.rglru_apply(tp, x),
                                   rglru.rglru_reference(tp, x),
                                   rtol=RTOL, atol=ATOL)
    a = torch.rand((3, S, 5), dtype=torch.float64)
    b = torch.randn((3, S, 5), dtype=torch.float64)
    h, want = torch.zeros((3, 5), dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b),
                               torch.stack(want, 1))


def test_short_prompts_raise():
    """A prefill shorter than conv_width - 1 = 3 inputs raises; one of 3
    fills the window, and its cache continues the sequence as the
    step-wise references do (the next output equal)."""
    _, sp = _ssd_params()
    _, rp = _rglru_params()
    x = torch.zeros((1, 2, D))
    with pytest.raises(ValueError, match="2 tokens"):
        ssd.ssd_apply(sp, x, chunk=8, want_cache=True, **SSD_KW)
    with pytest.raises(ValueError, match="2 tokens"):
        rglru.rglru_apply(rp, x, want_cache=True)
    x = torch.from_numpy(_x((2, 4, D), 8))
    with torch.no_grad():
        _, c = ssd.ssd_apply(sp, x[:, :3], chunk=8, want_cache=True,
                             **SSD_KW)
        torch.testing.assert_close(
            ssd.ssd_decode(sp, x[:, 3:], c, **SSD_KW)[0],
            ssd.ssd_reference(sp, x, **SSD_KW)[:, 3:], rtol=RTOL, atol=ATOL)
        _, c = rglru.rglru_apply(rp, x[:, :3], want_cache=True)
        torch.testing.assert_close(rglru.rglru_decode(rp, x[:, 3:], c)[0],
                                   rglru.rglru_reference(rp, x)[:, 3:],
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the two configs through the transformer
# --------------------------------------------------------------------------

S, GEN, B = 24, 6, 2


def _configs(name, layers=5, **changes):
    """(JAX cfg, port cfg) reduced; recurrentgemma-9b at ``layers``
    layers: five, a cycle (RG-LRU, RG-LRU, local attention) and a tail
    of two RG-LRU; three, the cycle alone."""
    if name == "recurrentgemma-9b":
        changes.update(n_layers=layers,
                       block_pattern=j_hybrid_pattern(layers),
                       sliding_window=16)
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), attn_impl="jnp",
                               **changes)
    tcfg = dataclasses.replace(get_config(name).reduced(),
                               attn_impl="pallas", **changes)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(port cfg, JAX cfg, port params, JAX params, tokens [B, S + GEN])."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    tparams = state_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, S + GEN)).astype(np.int32)
    return tcfg, jcfg, tparams, jparams, tokens


def test_params_carry_across_leaf_by_leaf(model):
    tcfg, jcfg, tparams, jparams, _ = model
    want = {jtu.keystr(p): np.asarray(l)
            for p, l in jtu.tree_flatten_with_path(jparams)[0]}
    got = {}
    tree_with_path(lambda p, t: got.__setitem__(
        "".join(f"[{k!r}]" for k in p), t), tparams)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.shape == want[k].shape
        assert np.array_equal(t.numpy(), want[k]), k
    kinds = set(tcfg.block_pattern)
    leaves = "".join(got)
    assert ("'ssd'" in leaves) == ("ssd" in kinds)
    assert ("'rglru'" in leaves) == ("rglru" in kinds)


def test_forward_seq_logits_and_gradients_match_jax(model):
    tcfg, jcfg, tparams, jparams, tokens = model
    g = _x((B, S, tcfg.vocab_size), 3)

    def jloss(p):
        lg = jtfm.forward_seq(jcfg, p, {"tokens": jnp.asarray(
            tokens[:, :S])})["logits"]
        return jnp.sum(lg * g) / g.size, lg

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams,
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    logits = tfm.forward_seq(tcfg, tp, {"tokens": torch.from_numpy(
        tokens[:, :S]).long()})["logits"]
    (torch.sum(logits * torch.from_numpy(g)) / g.size).backward()
    _close(logits, jlogits)
    _tree_close(jax.tree.map(lambda t: t.grad.numpy(), tp,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                jax.tree.map(np.asarray, jgrads), _close)


def test_prefill_then_decode_matches_jax_decode_step(model):
    """Prefill S tokens, then GEN decode steps fed the drawn tokens, each
    step's logits and the final cache (states, conv windows, K/V rings)
    against JAX's."""
    tcfg, jcfg, tparams, jparams, tokens = model
    jout = jax.jit(lambda p, t: jtfm.forward_seq(
        jcfg, p, {"tokens": t}, want_cache=True, max_cache_len=S + GEN))(
        jparams, jnp.asarray(tokens[:, :S]))
    jcache = jout["cache"]
    jstep = jax.jit(lambda p, t, c, pos: jtfm.decode_step(jcfg, p, t, c,
                                                          pos))
    with torch.no_grad():
        out = tfm.forward_seq(tcfg, tparams,
                              {"tokens": torch.from_numpy(tokens[:, :S])
                               .long()}, want_cache=True,
                              max_cache_len=S + GEN)
        cache = out["cache"]
        _close(out["logits"], jout["logits"])
        _tree_close(state_to_numpy(cache), jcache)
        for i in range(GEN):
            t = tokens[:, S + i:S + i + 1]
            jl, jcache = jstep(jparams, jnp.asarray(t), jcache,
                               jnp.int32(S + i))
            tl, cache = tfm.decode_step(tcfg, tparams,
                                        torch.from_numpy(t).long(), cache,
                                        S + i)
            _close(tl, jl)
    _tree_close(state_to_numpy(cache), jcache, _close)


def test_decode_graph_eager_shares_its_state_between_requests(model):
    """``DecodeGraph(graph=False)`` over two requests (the second's cache
    copied into the first's tensors, the SSD / RG-LRU states and conv
    windows included) against ``greedy_decode`` on each."""
    tcfg, _, tparams, _, tokens = model
    loop = serve.DecodeGraph(
        lambda p, t, c, pos: tfm.decode_step(tcfg, p, t, c, pos), tparams,
        GEN, graph=False)
    with torch.no_grad():
        for r in range(2):
            prompt = torch.from_numpy(np.roll(tokens[:, :S], r, 1)).long()
            last, cache = serve.prefill(tcfg, tparams, prompt, S + GEN)
            ids, logits, _ = loop.run(last, cache, S)
            last, cache = serve.prefill(tcfg, tparams, prompt, S + GEN)
            want_ids, want_logits, _ = serve.greedy_decode(
                tcfg, tparams, cache, last, S, GEN)
            assert torch.equal(ids, want_ids)
            assert torch.equal(logits, want_logits)
            assert loop.cache is not cache or r == 0


@pytest.mark.parametrize("name", NAMES)
def test_param_struct_and_cache_struct_at_full_size_match_jax(name):
    """Shapes only on both sides: recurrentgemma-9b's 7.48 B parameters and
    its 12 cycles + 2 tail layers."""
    cfg = get_config(name)
    js = jax.eval_shape(lambda k: jtfm.init_params(J_ARCHS[name], k),
                        jax.random.PRNGKey(0))

    def shapes(tree):
        out = {}
        tree_with_path(lambda p, s: out.__setitem__(
            "".join(f"[{k!r}]" for k in p), tuple(s)), tree)
        return out

    want = {jtu.keystr(p): tuple(l.shape)
            for p, l in jtu.tree_flatten_with_path(js)[0]}
    assert shapes(steps.param_struct(cfg)) == want
    jc = jax.eval_shape(lambda: jtfm.init_cache(J_ARCHS[name], 2, 64))
    assert shapes(tfm.cache_struct(cfg, 2, 64)) == {
        jtu.keystr(p): tuple(l.shape)
        for p, l in jtu.tree_flatten_with_path(jc)[0]}
    n = sum(int(np.prod(s)) for s in want.values())
    assert n == {"mamba2-130m": 128_946_624,
                 "recurrentgemma-9b": 7_483_805_696}[name]


@pytest.mark.parametrize("name", NAMES)
def test_param_and_cache_specs_match_jax(name):
    """``param_shardings`` (FSDP both ways) and ``cache_shardings`` of the
    full-size trees (SSD's ``w_in``, the states ``h`` and windows
    ``conv``) on the meshes the layouts meet."""
    cfg = get_config(name)
    jp = jax.eval_shape(lambda k: jtfm.init_params(J_ARCHS[name], k),
                        jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda: jtfm.init_cache(J_ARCHS[name], 4, 4096))
    for shape in ((1, 2), (2, 2), (16, 16), (2, 16, 16)):
        tm, jm = meshes(shape)
        for fsdp in (False, True):
            assert_specs_equal(
                t_sh.param_shardings(tm, steps.param_struct(cfg), fsdp=fsdp),
                j_sh.param_shardings(jm, jp, fsdp=fsdp))
        port = tfm.cache_struct(cfg, 4, 4096)
        assert port == to_port(jc)
        assert_specs_equal(t_sh.cache_shardings(tm, port),
                           j_sh.cache_shardings(jm, jc))


ENGINE_CASES = [("mamba2-130m", "fedmmd", "client_parallel"),
                ("recurrentgemma-9b", "fedfusion", "client_sequential")]


@pytest.mark.parametrize("name,algo,mode", ENGINE_CASES,
                         ids=["-".join(c) for c in ENGINE_CASES])
def test_lm_engine_equals_port_reference(name, algo, mode):
    """2 of 4 clients, 2 local steps of 2 x 16, 4 rounds in 2-round
    chunks, eval every 2 rounds: every leaf and the history equal, as
    ``tests/test_torch_lm_engine.py`` holds the dense LMs."""
    bundle = make_bundle(_configs(name, layers=3, vocab_size=64)[1])
    toks, src = token_stream(64, 16, vocab=64, n_sources=4, seed=0)
    test, _ = token_stream(8, 16, vocab=64, n_sources=4, seed=1)
    fl = FLConfig(algorithm=algo, fusion_op="conv", clients_per_round=2,
                  local_steps=2, local_batch=2, lr=0.05)
    kw = dict(rounds=4, seed=1, mode=mode, eval_every=2, eval_examples=8,
              device="cpu")
    runs = [run(bundle, fl, FederatedDataset(source_partition(toks, src, 4),
                                             {"tokens": test}, seed=0), **kw)
            for run in (functools.partial(run_federated, superstep_rounds=2),
                        run_federated_reference)]
    for a, b in zip(tree_leaves(runs[0].global_state),
                    tree_leaves(runs[1].global_state)):
        assert torch.equal(a, b)
    assert runs[0].comm.history == runs[1].comm.history
    assert all(np.isfinite(h["local_loss"]) for h in runs[0].comm.history)


@pytest.mark.parametrize("name", NAMES)
def test_launch_train_fedavg_round_matches_jax_round_fn(name):
    """``launch.train.train_rounds`` (each family in its own ``fl_mode``:
    mamba2-130m one client, recurrentgemma-9b, at one cycle, four visited
    in turn) against JAX's round function (``make_round_fn``, the round
    its ``build_train_step`` wraps, jitted without a mesh), 1 FedAvg
    round from the same state on the same numpy draws."""
    jcfg, tcfg = _configs(name, layers=3, vocab_size=256)
    fl_kw = dict(algorithm="fedavg", local_steps=2, lr=0.05)
    shape = ("custom_train", 16, 4, "train")
    plan_c = 1 if tcfg.fl_mode == "client_parallel" else 4
    j_round = jax.jit(j_make_round_fn(j_make_bundle(jcfg), JFL(**fl_kw),
                                      jcfg.fl_mode))
    s0 = j_init_global_state(j_make_bundle(jcfg), JFL(**fl_kw),
                             jax.random.PRNGKey(0))
    toks, src = j_token_stream(64, 16, vocab=jcfg.vocab_size,
                               n_sources=plan_c)
    parts = j_source_partition(toks, src, plan_c)
    rng = np.random.default_rng(0)
    arr = np.stack([parts[c]["tokens"][rng.choice(
        len(parts[c]["tokens"]), (2, 4 // plan_c))] for c in range(plan_c)])
    state, metrics = j_round(s0, {"tokens": jnp.asarray(arr[..., :-1]),
                                  "labels": jnp.asarray(arr[..., 1:])},
                             jnp.ones((plan_c,)), j_decay(0.05, 0.995)(0))
    got, records = train.train_rounds(
        tcfg, FLConfig(**fl_kw), InputShape(*shape), rounds=1,
        device="cpu",
        global_state=state_from_numpy(jax.tree.map(np.asarray, s0)),
        log=None)
    _tree_close(state_to_numpy(got), jax.tree.map(np.asarray, state))
    np.testing.assert_allclose(records[0]["loss"],
                               float(metrics["local_loss"]), rtol=RTOL,
                               atol=ATOL)


def test_recurrent_layers_refuse_a_model_axis():
    """The refusal is gone: a ``model`` axis of more than one rank runs the
    JAX layout's blocks.  Its arithmetic rank by rank in one process (m =
    2; ``tests/_torch_inputs.py``'s emulations, which call the modules'
    own stages): the RG-LRU layer (W split, the conv output joined before
    the gates) and the SSD layer (each rank the P slice of every head)
    against the whole layer, within rtol 1e-5 / atol 1e-6 (the parts'
    sum adds in another order), and each rank's RG-LRU cache blocks
    against the whole prefill cache's slices; ``init_cache`` under a
    stand-in rank context of (1, 2) is the rank's blocks under
    ``cache_shardings`` (SSD ``h`` on P, ``conv`` on conv_ch).  The mesh
    runs themselves are ``tests/test_torch_mesh.py``'s."""
    from _torch_inputs import rglru_by_ranks, ssd_by_ranks
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.parallel import ModelParallel, TensorParallel
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 12, 32), generator=gen)
    rp = rglru.rglru_init(gen, 32, 32)
    want, cache = rglru.rglru_apply(rp, x, want_cache=True)
    got, blocks = rglru_by_ranks(rp, x, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for r, b in enumerate(blocks):
        for k in ("h", "conv"):
            torch.testing.assert_close(b[k], cache[k].chunk(2, dim=-1)[r],
                                       rtol=1e-5, atol=1e-6)
    kw = dict(expand=2, d_state=8, head_dim=16, conv_width=4)
    sp = ssd.ssd_init(gen, 32, **kw)
    torch.testing.assert_close(ssd_by_ranks(sp, x, 2, chunk=4, **kw),
                               ssd.ssd_apply(sp, x, chunk=4, **kw),
                               rtol=1e-5, atol=1e-6)
    _, tcfg = _configs("mamba2-130m")
    mesh = MeshSpec((1, 2), ("data", "model"))
    specs = t_sh.cache_shardings(mesh, tfm.cache_struct(tcfg, 2, 8))
    tp = TensorParallel(ModelParallel(
        lambda axes: (None, 2 if "model" in axes else 1, 0)), {}, specs)
    whole = tfm.init_cache(tcfg, 2, 8, device="cpu")
    local = tfm.init_cache(tcfg, 2, 8, device="cpu", tp=tp)
    for a, b in zip(tree_leaves(whole), tree_leaves(local)):
        assert b.shape[:-2] == a.shape[:-2]
    layer = local["cycles"][0]
    d_inner = tcfg.ssm_expand * tcfg.d_model
    assert layer["h"].shape[-2] == tcfg.ssm_head_dim // 2
    assert layer["conv"].shape[-1] == (d_inner + 2 * tcfg.ssm_state) // 2