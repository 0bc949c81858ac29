"""The port's transformer serving path against the JAX package's, from the
same (converted) JAX parameters, on ``gemma3-1b.reduced()`` (a local and a
global layer, window 64, one KV head), ``smollm-135m.reduced()`` (two
KV heads, SwiGLU), ``stablelm-3b.reduced()`` at head dim 80 (25% partial
rotary, an untied head, rep 1) and ``h2o-danube-3-4b.reduced()`` at head
dim 120 (two sliding-window layers, window 64, rep 2), under both
``attn_impl`` values, on the CPU: prefill
logits and caches (S = 80 > the window, so the local ring buffer rolls),
four decode steps (logits and caches), the prefill-then-decode invariant,
and greedy serving against a JAX greedy loop.  Also: the configs carry
across from the JAX package, and what the port does not run yet raises.

Tolerance: float32.  XLA and PyTorch sum the matmuls and the softmax in
other orders (the JAX ``attn_impl="pallas"`` path runs the Pallas kernel in
interpret mode, the port the plain K8a / K9 versions); over two layers the
logits (|logits| up to ~20) agree to ~1e-5 of their scale: held at rtol
1e-4 with an atol of 1e-4 of each output's scale; caches likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import reduced

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.models import transformer as jtfm
from repro_torch.configs import ARCH_CONFIGS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels import flash_attn
from repro_torch.kernels.flash_attn import make_flash_attention
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import transformer as tfm

S, GEN, B = 80, 4, 2
NAMES = ("gemma3-1b", "smollm-135m", "stablelm-3b", "h2o-danube-3-4b")


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def _trees_close(got, want):
    got, want = state_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


@pytest.fixture(scope="module", params=[(n, impl) for n in NAMES
                                        for impl in ("jnp", "pallas")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(port cfg, JAX cfg, port params, JAX params, prompt tokens)."""
    name, impl = request.param
    jcfg = reduced(J_ARCHS[name], attn_impl=impl)
    tcfg = reduced(get_config(name), attn_impl=impl)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = state_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, S + GEN)).astype(np.int32)
    return tcfg, jcfg, tparams, jparams, tokens


def _jax_prefill(jcfg, jparams, tokens):
    return jtfm.forward_seq(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                            want_cache=True, max_cache_len=S + GEN)


def test_prefill_and_decode_match_jax(model):
    tcfg, jcfg, tparams, jparams, tokens = model
    jout = _jax_prefill(jcfg, jparams, tokens[:, :S])
    with torch.no_grad():
        tout = tfm.forward_seq(tcfg, tparams,
                               {"tokens": torch.from_numpy(tokens[:, :S])},
                               want_cache=True, max_cache_len=S + GEN)
    _close(tout["logits"], jout["logits"])
    _close(tout["features"], jout["features"])
    _trees_close(tout["cache"], jout["cache"])
    # local ring: the window's last 64 positions, rolled by S % 64
    if "attn_local" in tcfg.block_pattern:
        assert tout["cache"]["cycles"][0]["k"].shape[2] == 64

    jcache, tcache = jout["cache"], tout["cache"]
    for i in range(GEN):
        tok = tokens[:, S + i:S + i + 1]
        jlogits, jcache = jtfm.decode_step(jcfg, jparams, jnp.asarray(tok),
                                           jcache, jnp.int32(S + i))
        with torch.no_grad():
            tlogits, tcache2 = tfm.decode_step(
                tcfg, tparams, torch.from_numpy(tok), tcache, S + i)
        assert tcache2 is tcache                     # updated in place
        _close(tlogits, jlogits)
        _trees_close(tcache, jcache)


def test_prefill_then_decode_matches_forward(model):
    """forward(S+1 tokens).logits[:, -1] == decode(token S | prefill cache):
    the serving invariant of tests/test_smoke_archs.py, on the port."""
    tcfg, _, tparams, _, tokens = model
    toks = torch.from_numpy(tokens[:, :S + 1])
    with torch.no_grad():
        full = tfm.forward_seq(tcfg, tparams, {"tokens": toks})
        pre = tfm.forward_seq(tcfg, tparams, {"tokens": toks[:, :S]},
                              want_cache=True, max_cache_len=S + 1)
        logits, _ = registry.decode_step(tcfg, tparams, toks[:, S:],
                                         pre["cache"], torch.tensor(S))
    torch.testing.assert_close(logits[:, 0], full["logits"][:, -1],
                               atol=2e-3, rtol=2e-3)


def test_greedy_serving_matches_a_jax_greedy_loop(model):
    tcfg, jcfg, tparams, jparams, tokens = model
    prompt = tokens[:, :S]
    jout = _jax_prefill(jcfg, jparams, prompt)
    last, jcache = jout["logits"][:, -1], jout["cache"]
    want, want_logits = [], []
    for i in range(GEN):
        nxt = jnp.argmax(last, axis=-1)
        want.append(np.asarray(nxt))
        logits, jcache = jtfm.decode_step(jcfg, jparams, nxt[:, None],
                                          jcache, jnp.int32(S + i))
        last = logits[:, 0]
        want_logits.append(last)
    with torch.no_grad():
        tlast, tcache = serve.prefill(tcfg, tparams,
                                      torch.from_numpy(prompt), S + GEN)
        got, got_logits, step_ms = serve.greedy_decode(tcfg, tparams, tcache,
                                                       tlast, S, GEN)
    _close(tlast, jout["logits"][:, -1])
    assert got.tolist() == np.stack(want, 1).tolist()
    _close(got_logits, jnp.stack(want_logits, 1))
    assert len(step_ms) == GEN


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "smollm-135m", "--prompt-len",
                "20", "--gen-len", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "prefill" in out and "decode 3 tokens" in out


@pytest.mark.parametrize("name", NAMES)
def test_port_init_params_and_cache_match_jax_structure(name):
    tcfg, jcfg = reduced(get_config(name)), reduced(J_ARCHS[name])
    jp = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tp = state_to_numpy(tfm.init_params(tcfg, torch.Generator(),
                                        device="cpu"))
    jc = jax.tree.map(np.asarray, jtfm.init_cache(jcfg, 3, 70))
    tc = state_to_numpy(registry.init_cache(tcfg, 3, 70, device="cpu"))
    for t, j in ((tp, jp), (tc, jc)):
        assert jax.tree.structure(t) == jax.tree.structure(j)
        for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_init_cache_layers_do_not_alias():
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=13,
                              block_pattern=get_config(
                                  "gemma3-1b").block_pattern[:13],
                              d_model=64, d_ff=64, vocab_size=32,
                              head_dim=64)
    cache = tfm.init_cache(cfg, 1, 8, device="cpu")
    k = cache["cycles"][0]["k"]
    assert k.shape[0] == 2 and k.stride(0) != 0
    k[0].fill_(1.0)
    assert float(k[1].abs().sum()) == 0.0


@pytest.mark.parametrize("jname", sorted(J_ARCHS))
def test_every_jax_arch_config_is_representable(jname):
    jcfg = J_ARCHS[jname]
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert jname in ARCH_CONFIGS
    assert dataclasses.asdict(ARCH_CONFIGS[jname]) == \
        dataclasses.asdict(jcfg)
    assert get_config(jname) is ARCH_CONFIGS[jname]


@pytest.mark.parametrize("jname", ["whisper-large-v3", "qwen2-vl-7b"])
def test_unported_families_raise(jname):
    """Both families were refused under a ``model`` axis of more than one
    rank; they run there now (``tests/test_torch_mesh.py`` holds the mesh
    runs to one device).  Here: the prefill and decode steps build on
    (1, 2) and (2, 2) meshes of axis sizes (``MeshSpec``) with
    ``cache_shardings``' layouts, qwen2-vl-7b's FSDP train step with
    ``param_shardings(..., fsdp=True)``, and ``init_cache`` under a
    stand-in context of rank 0 of (1, 2) is each leaf's block under those
    specs (whisper-large-v3's cross cache split on its 16 frames)."""
    from repro_torch.configs import FLConfig, InputShape
    from repro_torch.launch import sharding as t_sh
    from repro_torch.launch import steps as t_steps
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.parallel import ModelParallel, TensorParallel
    cfg = ArchConfig(**dataclasses.asdict(J_ARCHS[jname])).reduced()
    for shape in ((1, 2), (2, 2)):
        mesh = MeshSpec(shape, ("data", "model"))
        _, _, _, (_, cache_specs) = t_steps.build_prefill_step(
            cfg, InputShape("p", 16, 2, "prefill"), mesh, max_len=32)
        assert cache_specs == t_sh.cache_shardings(
            mesh, tfm.cache_struct(cfg, 2, 32))
        _, _, lin, _ = t_steps.build_serve_step(
            cfg, InputShape("d", 32, 2, "decode"), mesh)
        assert lin[2] == cache_specs
    if cfg.fl_mode == "client_sequential":
        mesh = MeshSpec((2, 2), ("data", "model"))
        _, args, lin, lout = t_steps.build_train_step(
            cfg, FLConfig(), InputShape("t", 16, 8, "train"), mesh)
        assert lin[0] == lout[0] == t_sh.param_shardings(mesh, args[0],
                                                         fsdp=True)
    mesh = MeshSpec((1, 2), ("data", "model"))
    specs = t_sh.cache_shardings(mesh, tfm.cache_struct(cfg, 2, 8))
    tp = TensorParallel(ModelParallel(
        lambda axes: (None, 2 if "model" in axes else 1, 0)), {}, specs)
    whole = tfm.init_cache(cfg, 2, 8, device="cpu")
    local = tfm.init_cache(cfg, 2, 8, device="cpu", tp=tp)
    for name, t in local["cycles"][0].items():
        want = list(whole["cycles"][0][name].shape)
        want[2] //= 2             # [n, B, L or F, KV, hd]: L / F halved
        assert list(t.shape) == want, name
    assert ("xk" in local["cycles"][0]) == (cfg.n_enc_layers > 0)


def test_remat_and_the_transformer_bundle_raise():
    """Both were refused once; the name predates them.  ``remat`` runs now
    (``tests/test_torch_remat.py`` holds its losses and gradients): here
    a ``remat="layer"`` forward without autograd gives ``"none"``'s logits
    bit for bit.  The transformer bundle is built."""
    cfg = get_config("smollm-135m").reduced()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = {"tokens": torch.tensor([[3, 1, 4, 1, 5]])}
    with torch.no_grad():
        want = tfm.forward_seq(cfg, params, toks)["logits"]
        got = tfm.forward_seq(dataclasses.replace(cfg, remat="layer"),
                              params, toks)["logits"]
    assert torch.equal(got, want)
    cfg = get_config("smollm-135m")
    bundle = registry.make_bundle(cfg)
    assert (bundle.loss_kind, bundle.feature_channels) == ("lm", 576)
    assert bundle.config is cfg and bundle.name == "smollm-135m"
    toks = torch.tensor([[3, 1, 4, 1]])
    assert torch.equal(bundle.labels({"tokens": toks}),
                       torch.tensor([[1, 4, 1, 1]]))
    assert bundle.labels({"tokens": toks, "labels": toks}) is toks


def test_flash_attention_backward_is_not_ported():
    """Was: the backward raised until K8b / K8c were ported.  Now: the
    ``FlashAttention`` backward runs (on the CPU: ``flash_bwd_plain``) and
    matches autograd through the plain forward ``flash_fwd_plain``."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                   for s in ((1, 8, 2, 64), (1, 8, 1, 64), (1, 8, 1, 64),
                             (1, 8, 2, 64)))
    grads = []
    for fn in (make_flash_attention(causal=True, window=4),
               lambda *x: flash_attn.flash_fwd_plain(*x, window=4)[0]):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*x), x, do))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_state_from_numpy_carries_an_untied_head():
    """stablelm-3b's output head is its own leaf (not the embedding's
    transpose): converted from the JAX tree it arrives bit for bit, apart
    from the embedding, and the port's head_apply uses it."""
    jcfg = reduced(J_ARCHS["stablelm-3b"])
    tcfg = reduced(get_config("stablelm-3b"))
    assert not tcfg.tie_embeddings
    jparams = jax.tree.map(np.asarray,
                           jtfm.init_params(jcfg, jax.random.PRNGKey(3)))
    tparams = state_from_numpy(jparams)
    assert tparams["head"]["w"].shape == (tcfg.d_model, tcfg.vocab_size)
    assert np.array_equal(tparams["head"]["w"].numpy(), jparams["head"]["w"])
    assert not np.array_equal(jparams["head"]["w"],
                              jparams["embed"]["table"].T)
    back = state_to_numpy(tparams)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(jparams)))
    feats = torch.ones(1, tcfg.d_model)
    torch.testing.assert_close(tfm.head_apply(tcfg, tparams, feats),
                               feats @ tparams["head"]["w"])
