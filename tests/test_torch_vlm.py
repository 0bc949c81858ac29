"""The VLM family (qwen2-vl-7b) of the port against the JAX package, on
the CPU.

* ``models/rope.py``: ``mrope_angles`` / ``apply_mrope`` against JAX's with
  three distinct position streams (with equal streams M-RoPE is RoPE, and
  a wrong section map would not show), at the reduced sections and at
  qwen2-vl-7b's (16, 24, 24) pairs of head dim 128.
* Reduced qwen2-vl-7b (2 layers, 8 vision tokens): ``forward_seq`` logits
  and features with both ``attn_impl``\\ s and a batch carrying patch
  embeddings and non-trivial ``mrope_positions``; prefill and three decode
  steps against JAX's and against the forward; one FedAvg and one
  FedFusion-conv round (client-sequential, patch embeddings and M-RoPE
  positions in the stacked batch) against JAX's ``make_round_fn``;
  ``param_struct`` / ``cache_struct`` at full size against
  ``eval_shape``; ``launch.serve``; the refusals (a prompt shorter than
  its vision tokens, a ``model`` axis of more than one rank).

Tolerances: M-RoPE rtol 1e-4 / atol 1e-5; model logits, features,
caches and rounds rtol 1e-4 with an atol of 1e-4 of each tensor's scale,
as ``tests/test_torch_recurrent.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.core.rounds import make_round_fn as j_make_round_fn
from repro.models import rope as jrope
from repro.models import transformer as jtfm
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import make_round_fn
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import serve, steps
from repro_torch.models import make_bundle, rope
from repro_torch.models import transformer as tfm
from test_torch_tp_layouts import to_port

NAME = "qwen2-vl-7b"
RTOL, ATOL = 1e-4, 1e-5


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


def _close(got, want):
    """rtol 1e-4, atol 1e-4 of the expected values' scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def _tree_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def _cfgs(impl="jnp"):
    return (dataclasses.replace(J_ARCHS[NAME].reduced(), attn_impl=impl),
            dataclasses.replace(get_config(NAME).reduced(), attn_impl=impl))


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's copy) of reduced qwen2-vl-7b."""
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jp, state_from_numpy(jp)


def _streams(rng, lead, S):
    """Three distinct position streams [3, *lead, S]: temporal positions
    rising, height and width ids of a patch grid."""
    t = np.broadcast_to(np.arange(S), lead + (S,))
    h = rng.integers(0, 12, lead + (S,))
    w = rng.integers(0, 20, lead + (S,))
    return np.stack([t, h, w]).astype(np.int32)


def _batch(cfg, B, S, seed, mrope=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "vision_embeds": rng.standard_normal(
                 (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    if mrope:
        batch["mrope_positions"] = _streams(rng, (B,), S)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections,theta", [
    (64, (8, 12, 12), 1e6),       # reduced qwen2-vl-7b
    (128, (16, 24, 24), 1e6),     # qwen2-vl-7b
])
def test_mrope_matches_jax_with_three_distinct_streams(hd, sections, theta):
    rng = np.random.default_rng(hd)
    B, S, H, KV = 2, 11, 4, 2
    pos = _streams(rng, (B,), S)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cos, sin = rope.mrope_angles(torch.from_numpy(pos).long(), hd, theta,
                                 sections)
    jcos, jsin = jrope.mrope_angles(jnp.asarray(pos), hd, theta, sections)
    for a, b in ((cos, jcos), (sin, jsin)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    got = rope.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(pos).long(), theta=theta,
                           head_dim=hd, sections=sections)
    want = jrope.apply_mrope(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(pos), theta=theta, head_dim=hd,
                             sections=sections)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # equal streams: M-RoPE is RoPE, bit for bit
    same = torch.from_numpy(np.broadcast_to(pos[0], pos.shape).copy()).long()
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    a = rope.apply_mrope(qt, kt, same, theta=theta, head_dim=hd,
                         sections=sections)
    b = rope.apply_rope(qt, kt, same[0], theta=theta, head_dim=hd)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_angles(same, hd, theta, (1, 2, 3))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_forward_seq_matches_jax(weights, impl):
    """Logits and features of 2 x 14 positions, the first 8 patch
    embeddings, under three distinct M-RoPE streams, each ``attn_impl``
    (JAX's Pallas attention in interpret mode)."""
    jcfg, tcfg = _cfgs(impl)
    jp, tp = weights
    batch = _batch(tcfg, 2, 14, seed=1)
    want = jax.jit(lambda p, b: jtfm.forward_seq(jcfg, p, b))(jp, _j(batch))
    with torch.no_grad():
        got = tfm.forward_seq(tcfg, tp, _t(batch))
        plain = tfm.forward_seq(tcfg, tp, _t(_batch(tcfg, 2, 14, seed=1,
                                                     mrope=False)))
    for key in ("logits", "features"):
        _close(got[key], want[key])
    # the streams matter: the same tokens at plain positions differ
    assert (plain["logits"] - got["logits"]).abs().max() > 1e-3


def test_prefill_and_decode_match_jax_and_the_forward(weights):
    """Prefill of 12 positions (8 of them patch embeddings), then 3 decode
    steps: each step's logits and the final cache against JAX's, and the
    last step's logits against the forward over all 15 positions (the
    invariant of JAX's ``test_smoke_archs.py``; M-RoPE positions default
    to the token's position in every stream, as at decode)."""
    jcfg, tcfg = _cfgs("pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="jnp")
    jp, tp = weights
    batch = _batch(tcfg, 2, 15, seed=2, mrope=False)
    P, G = 12, 3
    pre = jax.jit(lambda p, b: jtfm.forward_seq(
        jcfg, p, b, want_cache=True, max_cache_len=P + G))(
            jp, dict(_j(batch), tokens=jnp.asarray(batch["tokens"][:, :P])))
    jstep = jax.jit(lambda p, t, c, pos: jtfm.decode_step(jcfg, p, t, c, pos))
    jcache = pre["cache"]
    tb = _t(batch)
    with torch.no_grad():
        cache = tfm.forward_seq(tcfg, tp, dict(tb, tokens=tb["tokens"][:, :P]),
                                want_cache=True, max_cache_len=P + G)["cache"]
        for i in range(G):
            want, jcache = jstep(jp, jnp.asarray(
                batch["tokens"][:, P + i:P + i + 1]), jcache,
                jnp.int32(P + i))
            lg, cache = tfm.decode_step(tcfg, tp,
                                        tb["tokens"][:, P + i:P + i + 1],
                                        cache, torch.tensor(P + i))
            _close(lg, want)
        full = tfm.forward_seq(tcfg, tp, tb)["logits"][:, -1]
    _tree_close(state_to_numpy(cache), jax.tree.map(np.asarray, jcache))
    _close(lg[:, 0], full.numpy())


@pytest.mark.parametrize("algorithm", ["fedavg", "fedfusion"])
def test_round_with_patches_in_the_batch_matches_jax(algorithm):
    """One client-sequential round of 2 clients x 2 local steps, patch
    embeddings and M-RoPE positions beside the tokens and labels in the
    stacked batch (every key sliced a step), from the same converted
    state: every leaf and the loss against JAX's ``make_round_fn``."""
    jcfg, tcfg = _cfgs()
    kw = dict(algorithm=algorithm, fusion_op="conv", local_steps=2, lr=0.05)
    js = j_init_global_state(j_make_bundle(jcfg), JFL(**kw),
                             jax.random.PRNGKey(0))
    per = [_batch(tcfg, 2, 10, seed=10 + i) for i in range(4)]
    batches = {k: np.stack([b[k] for b in per]).reshape(
        (2, 2) + per[0][k].shape) for k in per[0]}
    batches["labels"] = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, batches["tokens"].shape).astype(np.int32)
    j_round = jax.jit(j_make_round_fn(j_make_bundle(jcfg), JFL(**kw),
                                      "client_sequential"))
    want, jm = j_round(js, _j(batches), jnp.ones(2), jnp.float32(0.05))
    round_fn = make_round_fn(make_bundle(tcfg), FLConfig(**kw),
                             tcfg.fl_mode)
    got, tm = round_fn(state_from_numpy(jax.tree.map(np.asarray, js)),
                       _t(batches), torch.ones(2), 0.05)
    _tree_close(state_to_numpy(got), jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(float(tm["local_loss"]),
                               float(jm["local_loss"]), rtol=RTOL)


def test_param_and_cache_structs_match_jax_at_full_size():
    """``param_struct`` (with ``vis_proj``) and ``cache_struct`` of
    qwen2-vl-7b against ``jax.eval_shape``; the config field for field."""
    cfg, jcfg = get_config(NAME), J_ARCHS[NAME]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count() == 7_615_483_904
    assert steps.param_struct(cfg) == to_port(jax.eval_shape(
        lambda k: jtfm.init_params(jcfg, k), jax.random.PRNGKey(0)))
    assert tfm.cache_struct(cfg, 4, 1056) == to_port(jax.eval_shape(
        lambda: jtfm.init_cache(jcfg, 4, 1056)))


def test_serving_and_the_refusals(capsys):
    """``launch.serve.main`` serves reduced qwen2-vl-7b on the CPU (patch
    embeddings from ``serve.make_inputs``); a prompt shorter than its
    vision tokens raises ``ValueError`` naming both lengths.  A ``model``
    axis of more than one rank, once refused, runs
    (``tests/test_torch_mesh.py``); here the two facts its split rests
    on, rank by rank in one process (m = 2): M-RoPE on a rank's heads
    (head-parallel q and k) is that block of M-RoPE on all heads,
    exactly, and ``vis_proj``'s column blocks joined (the all-gather
    before the residual stream) are the whole projection (rtol 1e-6 /
    atol 1e-6: a product of fewer columns may sum in another order)."""
    serve.main(["--arch", NAME, "--device", "cpu", "--prompt-len", "12",
                "--gen-len", "3", "--batch", "2"])
    assert "decode 3 tokens" in capsys.readouterr().out
    _, tcfg = _cfgs()
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    short = _t(_batch(tcfg, 1, 5, seed=0, mrope=False))
    with pytest.raises(ValueError, match="5 tokens.*8 vision tokens"):
        tfm.forward_seq(tcfg, params, short)
    batch = _t(_batch(tcfg, 2, 9, seed=0))
    gen = torch.Generator().manual_seed(1)
    hd, H, KV = tcfg.head_dim, tcfg.n_heads, tcfg.n_kv_heads
    q = torch.randn((2, 9, H, hd), generator=gen)
    k = torch.randn((2, 9, KV, hd), generator=gen)
    kw = dict(theta=tcfg.rope_theta, head_dim=hd,
              sections=tcfg.mrope_sections)
    wq, wk = rope.apply_mrope(q, k, batch["mrope_positions"], **kw)
    for r in range(2):
        qs, ks = slice(r * H // 2, (r + 1) * H // 2), \
            slice(r * KV // 2, (r + 1) * KV // 2)
        gq, gk = rope.apply_mrope(q[:, :, qs], k[:, :, ks],
                                  batch["mrope_positions"], **kw)
        assert torch.equal(gq, wq[:, :, qs]) and torch.equal(gk, wk[:, :, ks])
    w = params["vis_proj"]["w"]
    ve = batch["vision_embeds"]
    torch.testing.assert_close(
        torch.cat([ve @ b for b in w.chunk(2, dim=1)], -1), ve @ w,
        rtol=1e-6, atol=1e-6)
