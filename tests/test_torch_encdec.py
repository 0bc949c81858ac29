"""The encoder-decoder family (whisper-large-v3) of the port against the
JAX package, on the CPU.

* ``models/layers.py``: the sinusoidal position table and the single
  position of decode, against JAX's.
* K8a / K8b / K8c without the causal mask (the Whisper encoder's
  self-attention under ``attn_impl="pallas"``): the plain versions and the
  CPU backward of ``FlashAttention`` against ``jax.vjp`` of JAX's Pallas
  ``make_flash_attention(causal=False)`` in interpret mode; K8c's and
  K8b's schedules (``dkv_plan`` / ``dq_plan`` at ``causal=False``)
  emulated tile by tile against the same; the three plans' tile tables at
  the encoder's ragged 1,500 = 23 x 64 + 28 positions.
* Reduced whisper-large-v3 (2 decoder and 2 encoder layers, 16 frames):
  ``forward_seq`` logits and features with both ``attn_impl``\\ s, prefill
  and decode equal to the forward, three ``decode_step``\\ s over the
  cross cache against JAX's, one FedAvg and one FedFusion-conv round
  (client-parallel, frame embeddings in the stacked batch) against JAX's
  ``make_round_fn``, ``param_struct`` / ``cache_struct`` at full size
  against ``eval_shape``, serving through ``launch.serve`` and
  ``examples/serve_decode_torch.py``, ``launch.steps``' train step, and
  the refusal of a ``model`` axis of more than one rank.

Tolerances: the position table and the attention kernels' plain
versions rtol 1e-4 / atol 1e-5 (the single position of decode adds 1.2e-7
x pos: two float32 exps of a frequency may differ by an ulp, and the angle
multiplies that by the position); model logits, features, caches and
rounds rtol 1e-4 with an atol of 1e-4 of each tensor's scale (reduced
whisper's tied head gives logits up to ~150, whose float32 sums XLA and
PyTorch take in other orders).  The schedules' emulations atol 1e-5 of
each gradient's largest element, as ``tests/test_torch_flash_backward.py``.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.core.rounds import make_round_fn as j_make_round_fn
from repro.kernels.flash_attn import make_flash_attention as j_make_flash
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.core import make_round_fn
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels import flash_attn
from repro_torch.launch import serve, steps
from repro_torch.models import layers, make_bundle
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves
from test_torch_flash_backward import _dkv_emulated, _dq_emulated
from test_torch_tp_layouts import to_port

NAME = "whisper-large-v3"
RTOL, ATOL = 1e-4, 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


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
    """(JAX params, the port's copy) of reduced whisper-large-v3."""
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jp, state_from_numpy(jp)


def _batch(cfg, B, S, seed):
    """Tokens [B, S] int32 and frame embeddings [B, F, d] float32."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "audio_frames": rng.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the position table, and attention without the causal mask
# --------------------------------------------------------------------------

def test_sinusoidal_positions_match_jax():
    for n, d in ((1500, 1280), (448, 1280), (16, 256)):
        np.testing.assert_allclose(
            _np(layers.sinusoidal_positions(n, d)),
            np.asarray(jlayers.sinusoidal_positions(n, d)), rtol=RTOL,
            atol=ATOL)
    # the single position in float32: XLA's and PyTorch's float32 exp may
    # give a frequency an ulp apart (6e-8 at most, 1.0 the largest), and
    # the angle multiplies that by pos: atol 1e-5 + 1.2e-7 * pos
    for pos in (0, 1, 63, 447, 1499):
        for d in (1280, 256):
            got = layers.sinusoidal_position_at(torch.tensor(pos), d)
            want = jlayers.sinusoidal_position_at(jnp.int32(pos), d)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=RTOL, atol=ATOL + 1.2e-7 * pos)
    # the two precisions agree at small positions only
    table = layers.sinusoidal_positions(64, 1280)
    at = torch.stack([layers.sinusoidal_position_at(torch.tensor(p), 1280)
                      for p in range(64)])
    torch.testing.assert_close(at, table, rtol=RTOL, atol=ATOL)
    # built once per (n_pos, dim, dtype, device): a forward reuses it
    assert layers.sinusoidal_positions(64, 1280) is table
    assert layers.sinusoidal_positions(64, 1280, device="cpu") is table
    assert layers.sinusoidal_positions(64, 1280, torch.float64) is not table


def _flash_inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 200, 4, 4, 64),       # whisper's rep 1, ragged: 12 x 16 + 8
    (1, 70, 28, 4, 128),      # qwen2-vl's rep 7 and head dim
])
def test_bidirectional_flash_matches_pallas_and_its_schedules(B, S, H, KV,
                                                              hd):
    """K8a / K8b / K8c's plain versions at ``causal=False``, the port's
    ``FlashAttention`` backward, and K8b's and K8c's schedules emulated
    under ``dq_plan`` / ``dkv_plan`` (several segments a tile) against
    ``jax.vjp`` of the Pallas kernels with ``causal=False``."""
    q, k, v, do = _flash_inputs(B, S, H, KV, hd, seed=S + H)
    flash = j_make_flash(causal=False, q_block=16, kv_block=16,
                         interpret=True)
    jo, vjp = jax.vjp(flash, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attn.flash_fwd_plain(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(o), np.asarray(jo), rtol=RTOL, atol=ATOL)
    for g, w in zip(flash_attn.flash_bwd_plain(tq, tk, tv, o, lse, tdo,
                                               causal=False), want):
        np.testing.assert_allclose(_np(g), w, rtol=RTOL, atol=ATOL)
    x = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attn.make_flash_attention(causal=False)(*x)
    for g, w in zip(torch.autograd.grad(out, x, tdo), want):
        np.testing.assert_allclose(_np(g), w, rtol=RTOL, atol=ATOL)
    dcap = flash_attn.flash_dcap(tdo, o, KV)
    dq_plan = flash_attn.dq_plan(B, S, H, KV, hd, False, None)
    dkv_plan = flash_attn.dkv_plan(B, S, H, KV, hd, False, None)
    assert dq_plan.max_ns > 1 and dkv_plan.max_ns > 1
    got = [_dq_emulated(tq, tk, tv, tdo, lse, dcap, dq_plan, False, None),
           *_dkv_emulated(tq, tk, tv, tdo, lse, dcap, dkv_plan, False,
                          None)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_plans_without_the_causal_mask_see_every_tile():
    """At the encoder's (4, 1,500, 20, 20, 64) with ``causal=False``: every
    K8a and K8b query tile walks all ceil(1,500 / key tile) key tiles from
    the first (the last one ragged: 1,500 = 23 x 64 + 28), every K8c key
    tile all query tiles from the first; the causal plans walk fewer."""
    args = (4, 1500, 20, 20, 64)
    fwd = flash_attn.fwd_plan(*args, False, None)
    dq = flash_attn.dq_plan(*args, False, None)
    dkv = flash_attn.dkv_plan(*args, False, None)
    n_q = -(-1500 // dq.positions)
    assert set(fwd.n_tiles) == {-(-1500 // fwd.key_tile)}
    assert len(fwd.n_tiles) == n_q
    assert set(dq.j_lo) == {0} and set(dq.n_tiles) == {-(-1500 // 64)}
    assert set(dkv.t_lo) == {0} and set(dkv.n_tiles) == {n_q}
    assert len(dkv.n_tiles) == -(-1500 // dkv.key_tile)
    for j in range(len(dkv.n_tiles)):
        covered = [t for a, e in dkv.segments(j) for t in range(a, e)]
        assert covered == list(range(n_q))
    causal = flash_attn.fwd_plan(*args, True, None)
    assert sum(causal.n_tiles) < sum(fwd.n_tiles)


# --------------------------------------------------------------------------
# the model: forward, prefill and decode, rounds, shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_forward_seq_matches_jax(weights, impl):
    """Logits and features of 2 x 12 tokens over 16 frames, each
    ``attn_impl`` (JAX's Pallas decoder attention in interpret mode; the
    port's encoder runs K8a's plain version without the causal mask)."""
    jcfg, tcfg = _cfgs(impl)
    jp, tp = weights
    batch = _batch(tcfg, 2, 12, seed=1)
    want = jax.jit(lambda p, b: jtfm.forward_seq(jcfg, p, b))(jp, _j(batch))
    with torch.no_grad():
        got = tfm.forward_seq(tcfg, tp, _t(batch))
    for key in ("logits", "features"):
        _close(got[key], want[key])
    assert float(got["aux"]) == 0.0


def _jax_serve(jcfg, jp, batch, P, G):
    """JAX's prefill of the first P tokens and G decode steps of the rest:
    (each step's logits, the final cache)."""
    pre = jax.jit(lambda p, b: jtfm.forward_seq(
        jcfg, p, b, want_cache=True, max_cache_len=P + G))(
            jp, dict(_j(batch), tokens=jnp.asarray(batch["tokens"][:, :P])))
    step = jax.jit(lambda p, t, c, pos: jtfm.decode_step(jcfg, p, t, c, pos))
    cache, logits = pre["cache"], []
    for i in range(G):
        lg, cache = step(jp, jnp.asarray(batch["tokens"][:, P + i:P + i + 1]),
                         cache, jnp.int32(P + i))
        logits.append(np.asarray(lg))
    return logits, jax.tree.map(np.asarray, cache)


def test_prefill_and_decode_match_jax_and_the_forward(weights):
    """Prefill of 12 tokens, then 3 decode steps over the self and cross
    caches (K9 over the cross cache with no valid length): each step's
    logits and the final cache (``xk`` / ``xv`` included) against JAX's,
    and the last step's logits against the forward over all 15 tokens
    (the invariant of JAX's ``test_smoke_archs.py``)."""
    jcfg, tcfg = _cfgs("pallas")
    jp, tp = weights
    batch = _batch(tcfg, 2, 15, seed=2)
    P, G = 12, 3
    want, want_cache = _jax_serve(dataclasses.replace(jcfg,
                                                      attn_impl="jnp"),
                                  jp, batch, P, G)
    tb = _t(batch)
    with torch.no_grad():
        cache = tfm.forward_seq(tcfg, tp, dict(tb, tokens=tb["tokens"][:, :P]),
                                want_cache=True, max_cache_len=P + G)["cache"]
        for i in range(G):
            lg, cache = tfm.decode_step(tcfg, tp,
                                        tb["tokens"][:, P + i:P + i + 1],
                                        cache, torch.tensor(P + i))
            _close(lg, want[i])
        full = tfm.forward_seq(tcfg, tp, tb)["logits"][:, -1]
    assert set(cache["cycles"][0]) == {"k", "v", "xk", "xv"}
    _tree_close(state_to_numpy(cache), want_cache)
    _close(lg[:, 0], full.numpy())


@pytest.mark.parametrize("algorithm", ["fedavg", "fedfusion"])
def test_round_with_frames_in_the_batch_matches_jax(algorithm):
    """One client-parallel round of 2 clients x 2 local steps, frame
    embeddings beside the tokens and labels in the stacked batch [2, 2, B,
    ...], from the same converted state: every leaf and the loss against
    JAX's ``make_round_fn``."""
    jcfg, tcfg = _cfgs()
    kw = dict(algorithm=algorithm, fusion_op="conv", local_steps=2, lr=0.05)
    js = j_init_global_state(j_make_bundle(jcfg), JFL(**kw),
                             jax.random.PRNGKey(0))
    per = [_batch(tcfg, 2, 8, seed=10 + i) for i in range(4)]
    batches = {k: np.stack([b[k] for b in per]).reshape(
        (2, 2) + per[0][k].shape) for k in per[0]}
    batches["labels"] = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, batches["tokens"].shape).astype(np.int32)
    j_round = jax.jit(j_make_round_fn(j_make_bundle(jcfg), JFL(**kw),
                                      "client_parallel"))
    want, jm = j_round(js, _j(batches), jnp.ones(2), jnp.float32(0.05))
    round_fn = make_round_fn(make_bundle(tcfg), FLConfig(**kw),
                             tcfg.fl_mode)
    got, tm = round_fn(state_from_numpy(jax.tree.map(np.asarray, js)),
                       _t(batches), torch.ones(2), 0.05)
    _tree_close(state_to_numpy(got), jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(float(tm["local_loss"]),
                               float(jm["local_loss"]), rtol=RTOL)


def test_param_and_cache_structs_match_jax_at_full_size():
    """``param_struct`` and ``cache_struct`` of whisper-large-v3 (32 + 32
    layers) against ``jax.eval_shape``: the encoder stack, the decoder
    layers' cross-attention and layer-norm biases, the cross cache of
    1,500 frames; init draws the reduced tree leaf for leaf."""
    cfg, jcfg = get_config(NAME), J_ARCHS[NAME]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert steps.param_struct(cfg) == to_port(jax.eval_shape(
        lambda k: jtfm.init_params(jcfg, k), jax.random.PRNGKey(0)))
    assert tfm.cache_struct(cfg, 4, 96) == to_port(jax.eval_shape(
        lambda: jtfm.init_cache(jcfg, 4, 96)))
    jcfg_r, tcfg_r = _cfgs()
    drawn = tfm.init_params(tcfg_r, torch.Generator(), device="cpu")
    assert steps.param_struct(tcfg_r) == {
        k: v for k, v in _shapes(drawn).items()}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return tree.shape


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_serving_entry_points_run_the_encoder_decoder(capsys):
    """``launch.serve.main`` and the example twin serve reduced whisper on
    the CPU (frame embeddings from ``serve.make_inputs``); the serve
    step's cache carries the cross cache; ``build_train_step`` takes the
    frame embeddings ``input_specs`` names."""
    serve.main(["--arch", NAME, "--device", "cpu", "--prompt-len", "12",
                "--gen-len", "3", "--batch", "2"])
    assert "decode 3 tokens" in capsys.readouterr().out
    path = os.path.join(HERE, "..", "examples", "serve_decode_torch.py")
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    ids = twin.main(["--arch", NAME, "--device", "cpu", "--prompt-len", "8",
                     "--gen-len", "3", "--batch", "2"])
    assert ids.shape == (2, 3)
    _, tcfg = _cfgs()
    inputs = serve.make_inputs(tcfg, 2, seed=0, device="cpu")
    assert inputs["audio_frames"].shape == (2, 16, tcfg.d_model)
    shape = InputShape("t", 8, 4, "train")
    fn, args, _, _ = steps.build_train_step(tcfg, FLConfig(), shape)
    assert args[1]["audio_frames"][0] == (1, 2, 4, 16, tcfg.d_model)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    from repro_torch.core import init_global_state
    state = init_global_state(make_bundle(tcfg), FLConfig(),
                              torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (1, 2, 4, 8))),
             "labels": torch.from_numpy(rng.integers(0, 512, (1, 2, 4, 8))),
             "audio_frames": torch.from_numpy(rng.standard_normal(
                 (1, 2, 4, 16, tcfg.d_model)).astype(np.float32))}
    _, metrics = fn(state, batch, torch.ones(1), 0.05)
    assert np.isfinite(float(metrics["local_loss"]))
    assert len(tree_leaves(params)) == len(tree_leaves(state["model"]))


def test_a_model_axis_is_refused_and_frames_are_required():
    """A ``model`` axis of more than one rank and a cross cache split over
    ranks were refused; both run now (``tests/test_torch_mesh.py``).
    Here the split cross cache's arithmetic: a (2, 1) mesh's layouts at
    batch 1 split the 16 frames over ``data`` (8 + 8); one-token
    attention over each slice with no valid length and each row's
    log-sum-exp (K9's plain version), merged
    (``decode_attn.merge_partials``), is the attention over the whole
    cross cache that prefill wrote, within rtol 1e-6 / atol 1e-6 (the
    merge's weighted sum rounds elements near 0 by ~1e-7).  A batch
    without frame embeddings is refused by name."""
    from repro_torch.kernels.decode_attn import (flash_decode_plain,
                                                 merge_partials)
    from repro_torch.launch import mesh as t_mesh
    from repro_torch.launch import sharding as t_sh
    _, tcfg = _cfgs()
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = _t(_batch(tcfg, 1, 4, seed=0))
    mesh = t_mesh.MeshSpec((2, 1), ("data", "model"))
    cache_specs = t_sh.cache_shardings(mesh, tfm.cache_struct(tcfg, 1, 8))
    assert "data" in t_sh.spec_axes(cache_specs["cycles"][0]["xk"][2])
    with torch.no_grad():
        cache = tfm.forward_seq(tcfg, params, batch, want_cache=True,
                                want_logits=False)["cache"]
    xk, xv = cache["cycles"][0]["xk"][0], cache["cycles"][0]["xv"][0]
    q = torch.randn((1, 1, tcfg.n_heads, tcfg.head_dim),
                    generator=torch.Generator().manual_seed(1))
    parts = [flash_decode_plain(q, k, v, want_lse=True) for k, v in
             zip(xk.chunk(2, dim=1), xv.chunk(2, dim=1))]
    merged = merge_partials(torch.stack([o for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(merged, flash_decode_plain(q, xk, xv),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="audio_frames"):
        tfm.forward_seq(tcfg, params, {"tokens": batch["tokens"]})
