"""The decode loop of the port (``launch.serve.DecodeGraph``) and the twin
of ``examples/serve_decode.py`` (``examples/serve_decode_torch.py``) on
the CPU: the twin's loop against the JAX example's loop (rebuilt here
from ``tfm.forward_seq`` and the jitted ``tfm.decode_step``, as the
example runs them) on the same (converted) parameters and prompts, at
temperature 0 and, with the same Gumbel noise handed to both, at 0.7: the
ids must be equal; on the CPU the loop runs its step eagerly and equals
``greedy_decode`` bit for bit, a second request through the same loop
too, and a capture is refused.  The capture itself runs on the card
(``tests/test_torch_cuda.py``).
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
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.interop import state_from_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
P, G, B = 24, 6, 2
NAMES = ("gemma3-1b", "granite-moe-1b-a400m")


def _twin():
    path = os.path.join(HERE, "..", "examples", "serve_decode_torch.py")
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(port cfg, JAX cfg, port params, JAX params, prompts [B, P])."""
    jcfg = J_ARCHS[request.param].reduced()
    tcfg = dataclasses.replace(get_config(request.param).reduced(),
                               attn_impl="pallas")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = state_from_numpy(jax.tree.map(np.asarray, jparams))
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, P)).astype(np.int32)
    return tcfg, jcfg, tparams, jparams, prompts


def _jax_loop(jcfg, jparams, prompts, temperature=0.0, noise=None):
    """``examples/serve_decode.py``'s loop, the key's draws replaced by
    ``noise`` [G, B, V] (``categorical(key, l / T)`` is ``argmax(l / T +
    gumbel)``)."""
    out = jax.jit(lambda p, b: jtfm.forward_seq(
        jcfg, p, b, want_cache=True, max_cache_len=P + G))(
            jparams, {"tokens": jnp.asarray(prompts)})
    step = jax.jit(lambda p, t, c, pos: jtfm.decode_step(jcfg, p, t, c, pos))
    cache, last, toks = out["cache"], out["logits"][:, -1], []
    for i in range(G):
        if temperature > 0:
            nxt = jnp.argmax(last / temperature + noise[i], axis=-1)
        else:
            nxt = jnp.argmax(last, axis=-1)
        toks.append(nxt)
        logits, cache = step(jparams, nxt[:, None], cache, jnp.int32(P + i))
        last = logits[:, 0]
    return np.asarray(jnp.stack(toks, axis=1))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_twin_loop_matches_the_jax_example_loop(model, temperature):
    tcfg, jcfg, tparams, jparams, prompts = model
    noise = None
    if temperature > 0:
        noise = serve.gumbel_noise(G, B, tcfg.vocab_size, seed=7,
                                   device="cpu")
    want = _jax_loop(jcfg, jparams, prompts, temperature,
                     None if noise is None else jnp.asarray(noise.numpy()))
    ids, _, _, loop = _twin().generate(
        tcfg, tparams, torch.from_numpy(prompts).long(), G,
        temperature=temperature, noise=noise)
    assert not loop.graph_mode
    np.testing.assert_array_equal(ids.numpy(), want)


def test_sampling_is_gumbel_max_of_the_scaled_logits():
    logits = torch.randn(3, 11, generator=torch.Generator().manual_seed(0))
    g = serve.gumbel_noise(1, 3, 11, seed=2, device="cpu")[0]
    assert torch.isfinite(g).all()
    assert torch.equal(serve.next_token(logits, 0.5, g),
                       (logits / 0.5 + g).argmax(-1))
    assert torch.equal(serve.next_token(logits), logits.argmax(-1))
    assert torch.equal(g, serve.gumbel_noise(1, 3, 11, seed=2,
                                             device="cpu")[0])


def test_decode_loop_on_the_cpu_equals_greedy_decode_twice(model):
    """Two requests through one loop (the second copied into the first's
    cache tensors) against ``greedy_decode`` on each, bit for bit."""
    tcfg, _, tparams, _, prompts = model
    loop = serve.DecodeGraph(
        lambda p, t, c, pos: tfm.decode_step(tcfg, p, t, c, pos), tparams,
        G, graph=False)
    first_cache = None
    for seed in (1, 2):
        tokens = serve.make_prompts(tcfg, B, P, seed=seed, device="cpu")
        with torch.no_grad():
            last, cache = serve.prefill(tcfg, tparams, tokens, P + G)
            want = serve.greedy_decode(
                tcfg, tparams, tree_map(torch.clone, cache), last, P, G)
            got = loop.run(last, cache, P)
        if first_cache is None:
            first_cache = cache
        assert loop.cache is first_cache
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(got[2]) == G
    with pytest.raises(ValueError, match="shapes"):
        loop.run(last[:1], tree_map(lambda t: t[..., :1, :, :, :]
                                    if t.dim() == 5 else t[:1], cache), P)


def test_decode_loop_refuses_a_capture_on_the_cpu(model):
    tcfg, _, tparams, _, prompts = model
    with torch.no_grad():
        last, cache = serve.prefill(tcfg, tparams,
                                    torch.from_numpy(prompts).long(), P + G)
        loop = serve.DecodeGraph(
            lambda p, t, c, pos: tfm.decode_step(tcfg, p, t, c, pos),
            tparams, G, graph=True)
        with pytest.raises(ValueError, match="CUDA"):
            loop.run(last, cache, P)
        with pytest.raises(ValueError, match="noise"):
            serve.DecodeGraph(None, tparams, G, temperature=0.5,
                              graph=False).run(last, cache, P)
    assert serve.decode_mode("cpu") == "eager (cpu)"


def test_twin_main_runs_on_the_cpu(capsys):
    ids = _twin().main(["--device", "cpu", "--arch", "arctic-480b",
                        "--prompt-len", "12", "--gen-len", "3", "--batch",
                        "2", "--temperature", "0.7"])
    out = capsys.readouterr().out.splitlines()
    assert ids.shape == (2, 3)
    assert out[0].startswith("prefill[2x12]:")
    assert out[1].startswith("decode 3 steps:")
    assert out[2] == f"generated token ids (first sequence): " \
        f"{ids[0].tolist()}"


def test_serve_launcher_says_how_it_decodes(capsys):
    serve.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m",
                "--prompt-len", "12", "--gen-len", "3", "--batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "decode: eager (cpu)"
    assert "decode 3 tokens" in out[-1]
