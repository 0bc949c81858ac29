"""Serving launcher: batched prefill, then greedy decode from the KV cache
(port of ``repro/launch/serve.py``).

Usage (on the card; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --scale full --batch 4 --prompt-len 1024 --gen-len 32
    torchrun --nproc-per-node=2 -m repro_torch.launch.serve --device cpu

A process that is one rank of several runs on the JAX launcher's mesh
(``launch.train.mesh_from_devices``): prefill and each decode step are
``launch.steps.build_prefill_step`` / ``build_serve_step`` on this rank's
blocks (the model split over ``model``, the batch over ``data`` where it
divides, the KV cache's length over ``model``; an SSD or RG-LRU layer's
state and conv window split on their channels, the encoder-decoder's
cross cache on its frames), for every family; ids are gathered and only
rank 0 prints.  A lone process serves on one device.

The decode loop is a :class:`DecodeGraph`, the counterpart of the JAX
launcher's ``jax.jit(decode_step)``: on the card one step is captured once
as a CUDA graph and replayed once a token (``decode: graph``).  A gloo
mesh decodes eagerly (``decode: eager (gloo)``): every gloo collective
waits on the host, so its steps cannot be captured; so does the CPU
(``decode: eager (cpu)``).  The first line printed says which.

``--attn-impl`` defaults to ``pallas``: prefill attention runs K8a and
decode attention K9 (the JAX launcher has no flag for it and serves with
the config's ``jnp`` attention).  Weights are random, drawn from a seeded
generator on the device; prompts are drawn with numpy.  Both use seed 0.
The VLM's and the encoder-decoder's stub inputs (qwen2-vl-7b's patch
embeddings, whisper-large-v3's frame embeddings) are standard normal,
drawn on the device from a ``torch.Generator`` seeded with the prompts'
seed (:func:`make_inputs`), as the JAX launcher draws them with
``jax.random.normal``; the decode graph reads the cross cache prefill
wrote and copies it with the rest of a request's cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_CONFIGS, InputShape, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attn
from repro_torch.launch import sharding as sh
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map


def make_prompts(cfg, batch, prompt_len, seed=0, device=None):
    """[batch, prompt_len] int64 token ids, uniform over the vocabulary,
    drawn with numpy from ``seed``, on ``device`` (None: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    return torch.from_numpy(ids).to(device)


def make_inputs(cfg, batch, seed=0, device=None):
    """The stub inputs of a request of ``batch`` prompts beside its tokens:
    ``{"vision_embeds": [batch, n_vision_tokens, d]}`` (VLM),
    ``{"audio_frames": [batch, n_audio_frames, d]}`` (audio), or ``{}``;
    standard normal, drawn on ``device`` (None: the card) from a
    ``torch.Generator`` there seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {}
    if cfg.family == "vlm":
        shapes["vision_embeds"] = (batch, cfg.n_vision_tokens, cfg.d_model)
    if cfg.family == "audio":
        shapes["audio_frames"] = (batch, cfg.n_audio_frames, cfg.d_model)
    return {k: torch.randn(v, generator=gen, device=device)
            for k, v in shapes.items()}


def prefill(cfg, params, tokens, max_len, inputs=None):
    """Runs the prompt (and ``inputs``, :func:`make_inputs`' stub
    embeddings) through the model on one device, filling a KV cache of
    ``max_len`` positions: ``build_prefill_step(..., last_only=True)``.
    Returns (the last position's logits [B, V], the cache).  Only the last
    row goes through the head (the serving loop reads nothing else)."""
    B, S = tokens.shape
    pre = build_prefill_step(cfg, InputShape("serve_prefill", S, B,
                                             "prefill"),
                             max_len=max_len, last_only=True)[0]
    return pre(params, {"tokens": tokens, **(inputs or {})})


def serve_steps(cfg, batch, prompt_len, gen_len, mesh=None):
    """``(prefill, step, params layout, tokens layout)`` of a serving run
    (``launch.steps``): ``prefill(params, {"tokens"}) -> (last logits [B,
    V], cache)`` with a cache of ``prompt_len + gen_len`` positions and
    ``step(params, tokens [B, 1], cache, pos) -> (logits [B, 1, V],
    cache)``, on this rank's blocks under ``mesh`` (the layouts None
    without one)."""
    max_len = prompt_len + gen_len
    pre, _, pre_in, _ = build_prefill_step(
        cfg, InputShape("serve_prefill", prompt_len, batch, "prefill"),
        mesh, max_len=max_len, last_only=True)
    step, _, step_in, _ = build_serve_step(
        cfg, InputShape("serve_decode", max_len, batch, "decode"), mesh)
    if mesh is None:
        return pre, step, None, None
    return pre, step, step_in[0], pre_in[1]["tokens"]


def sharded_params(cfg, mesh, layout, device=None, seed=0):
    """This rank's contiguous blocks of the weights ``init_params`` draws
    from ``seed`` on ``device``: the whole is drawn, cut, and freed."""
    device = resolve_device(device)
    whole = tfm.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed), device=device)
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                    sh.shard_tree(whole, layout, mesh))


def next_token(logits, temperature=0.0, noise=None):
    """The next token [B] (int64) of ``logits`` [B, V]: the argmax, or with
    ``temperature > 0`` the Gumbel-max sample ``argmax(logits / T +
    noise)`` (``noise`` [B, V] standard Gumbel), which is what
    ``jax.random.categorical(key, logits / T)`` computes with its own
    draws."""
    if temperature > 0:
        return (logits / temperature + noise).argmax(-1)
    return logits.argmax(-1)


def gumbel_noise(gen_len, batch, vocab, seed, device=None):
    """[gen_len, batch, vocab] standard Gumbel noise, ``-log(-log u)`` of
    uniforms drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed``, then moved to ``device`` (None: the card): the same numbers
    on every device."""
    device = resolve_device(device)
    u = torch.rand((gen_len, batch, vocab),
                   generator=torch.Generator().manual_seed(seed))
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _gloo_mesh(mesh) -> bool:
    import torch.distributed as dist
    return mesh is not None and dist.get_backend() == "gloo"


def decode_mode(device, mesh=None) -> str:
    """How a serving run on ``device`` (and ``mesh``) decodes: ``graph``
    (the card), ``eager (gloo)`` or ``eager (cpu)``."""
    if _gloo_mesh(mesh):
        return "eager (gloo)"
    return "eager (cpu)" if torch.device(device).type == "cpu" else "graph"


class _StepClock:
    """Stamps between decode steps: CUDA events recorded on the card (the
    loop never waits for the device), the host clock elsewhere."""

    def __init__(self, device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.stamps = []

    def stamp(self):
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def step_ms(self):
        """Each step's ms, between consecutive stamps."""
        pairs = list(zip(self.stamps, self.stamps[1:]))
        if self.on_card:
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


class DecodeGraph:
    """A serving run's decode loop as one step captured once and replayed
    once a token: the port's counterpart of the JAX launchers'
    ``jax.jit(lambda p, t, c, pos: decode_step(...))``, which compiles the
    step once per shape and calls it once per token.

    ``step(params, tokens [B, 1], cache, pos) -> (logits [B, 1, V],
    cache)`` updates the cache in place (``tfm.decode_step`` on one
    device, or ``serve_steps``' step on this rank's blocks; an
    encoder-decoder's cache also holds the cross keys and values, which a
    step reads only, copied and restored with the rest).  One step
    of the loop, on the device only: read the static ``tokens`` and the
    0-d ``pos``; run ``step``; write its logits into row ``pos - start`` of
    a static [B, gen_len, V] output and the token it decoded into the same
    column of a [B, gen_len] one (device indices, no host value); write the
    next token into ``tokens`` (the argmax, or with ``temperature > 0``
    the argmax of ``logits / T + noise[i + 1]``, ``noise`` a static
    [gen_len, B, V] buffer of Gumbel noise); add one to ``pos``.

    ``graph=True`` (the card) captures that step as a CUDA graph on the
    first :meth:`run`, after one eager warm-up step on a side stream
    (it builds K9's ticket buffer, cuBLAS's workspaces and any kernel
    built on first use).  The warm-up advances the cache like any step
    (the first token's K/V in its slot; an SSD or RG-LRU layer's state
    and conv window one token on), so the cache is copied before it and
    restored after it.  Later requests share the graph: :meth:`run` copies their
    caches into the captured cache tensors (the first request's, adopted),
    so ``prefill`` keeps its own allocation and the graph is never
    re-captured.  A capture that fails raises; nothing falls back to eager
    steps.  ``graph=False`` runs the same step eagerly (the CPU, a gloo
    mesh).  Capture is refused on the CPU and on a gloo mesh (``mesh``):
    gloo's collectives wait on the host.

    The kernels' ``launches`` counters count Python calls: the warm-up and
    the capture tick them once each, the replays never;
    ``launches_per_replay`` holds the capture's count of K9 launches."""

    def __init__(self, step, params, gen_len, *, temperature=0.0,
                 graph=True, mesh=None):
        if graph and _gloo_mesh(mesh):
            raise ValueError("DecodeGraph: a CUDA graph cannot capture a "
                             "gloo mesh's decode step (every gloo "
                             "collective waits on the host); pass "
                             "graph=False to decode eagerly")
        self.step, self.params, self.gen_len = step, params, gen_len
        self.temperature, self.graph_mode = temperature, graph
        self.cache = self.graph = None
        self.replays = 0
        self.stats = {}

    def _static(self, last, cache):
        """Adopts the first request's cache and allocates the loop's
        static buffers."""
        B, V = last.shape
        dev = self.device = last.device
        if self.graph_mode and dev.type != "cuda":
            raise ValueError(f"DecodeGraph: capture needs a CUDA device, "
                             f"not {dev}; pass graph=False")
        G = self.gen_len
        self.cache = cache
        self.tokens = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.start = torch.zeros((), dtype=torch.int64, device=dev)
        self.logits = torch.zeros((B, G, V), dtype=last.dtype, device=dev)
        self.ids = torch.zeros((B, G), dtype=torch.int64, device=dev)
        self.noise = (torch.zeros((G, B, V), dtype=torch.float32,
                                  device=dev)
                      if self.temperature > 0 else None)

    def _sample(self, logits, i):
        noise = None if self.noise is None else \
            self.noise.index_select(0, i).reshape(logits.shape)
        return next_token(logits, self.temperature, noise)

    def _body(self):
        logits, _ = self.step(self.params, self.tokens, self.cache,
                              self.pos)
        last = logits[:, 0]
        i = (self.pos - self.start).reshape(1)
        self.logits.index_copy_(1, i, last[:, None])
        self.ids.index_copy_(1, i, self.tokens)
        self.tokens.copy_(self._sample(
            last, (i + 1).clamp(max=self.gen_len - 1))[:, None])
        self.pos += 1

    def _begin(self, last, start_pos, noise):
        self.start.fill_(start_pos)
        self.pos.fill_(start_pos)
        if noise is not None:
            self.noise.copy_(noise)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.tokens.copy_(self._sample(last, zero)[:, None])

    def _capture(self, last, start_pos, noise):
        self._begin(last, start_pos, noise)
        before = tree_map(torch.clone, self.cache)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        # undo the warm-up's step: the cache, the position and the token
        tree_map(lambda d, s: d.copy_(s), self.cache, before)
        del before
        self._begin(last, start_pos, noise)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        k9 = decode_attn.flash_decode_cuda.launches
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._body()
            t1 = time.perf_counter()
        self.stats = dict(
            warmup_s=warmup_s, capture_s=t1 - t0,
            instantiate_s=time.perf_counter() - t1,
            pool_bytes=torch.cuda.memory_reserved() - reserved0,
            launches_per_replay={
                "flash_decode": decode_attn.flash_decode_cuda.launches - k9})
        self._ptrs = [t.data_ptr() for t in tree_leaves(
            (self.params, self.cache))]

    def run(self, last_logits, cache, start_pos, noise=None):
        """Decodes ``gen_len`` tokens after a prefill: ``last_logits`` [B,
        V] its last row, ``cache`` its cache (of the first request's
        shapes), ``start_pos`` the first decoded position, ``noise``
        [gen_len, B, V] with ``temperature > 0``.  Returns (tokens [B,
        gen_len], each step's logits [B, gen_len, V], each step's ms), as
        :func:`greedy_decode` does; on the card the step times come from
        CUDA events between the replays."""
        if (noise is None) != (self.temperature <= 0):
            raise ValueError("DecodeGraph.run: noise goes with "
                             "temperature > 0, and only with it")
        first = self.cache is None
        if first:
            self._static(last_logits, cache)
        else:
            if last_logits.shape != self.logits[:, 0].shape or [
                    t.shape for t in tree_leaves(cache)] != [
                    t.shape for t in tree_leaves(self.cache)]:
                raise ValueError("DecodeGraph.run: a request must have the "
                                 "first one's batch, vocabulary and cache "
                                 "shapes")
            if cache is not self.cache:
                tree_map(lambda d, s: d.copy_(s), self.cache, cache)
        if self.graph_mode and first:
            self._capture(last_logits, start_pos, noise)
        else:
            self._begin(last_logits, start_pos, noise)
        if self.graph_mode and [t.data_ptr() for t in tree_leaves(
                (self.params, self.cache))] != self._ptrs:
            raise RuntimeError("DecodeGraph: a captured buffer moved")
        clock = _StepClock(self.device)
        clock.stamp()
        for _ in range(self.gen_len):
            if self.graph_mode:
                self.graph.replay()
                self.replays += 1
            else:
                self._body()
            clock.stamp()
        return self.ids.clone(), self.logits.clone(), clock.step_ms()


def greedy_decode(cfg, params, cache, last_logits, start_pos, gen_len,
                  step=None):
    """``gen_len`` greedy steps from the prefill's last logits: token i is
    argmax of the previous logits and is decoded at position start_pos + i
    (the cache is updated in place) by ``step(params, tokens, cache, pos)``
    (default: ``tfm.decode_step`` on one device).  Returns (tokens [B,
    gen_len], each step's logits [B, gen_len, V], each step's wall ms).  On
    the card the step times come from CUDA events recorded between the
    steps, so the loop never waits for the device."""
    if step is None:
        def step(p, t, c, pos):
            return tfm.decode_step(cfg, p, t, c, pos)
    dev = last_logits.device
    pos = torch.tensor(start_pos, dtype=torch.int64, device=dev)
    clock = _StepClock(dev)
    toks, step_logits = [], []
    clock.stamp()
    for _ in range(gen_len):
        nxt = last_logits.argmax(-1)
        toks.append(nxt)
        logits, cache = step(params, nxt[:, None], cache, pos)
        last_logits = logits[:, 0]
        step_logits.append(last_logits)
        pos += 1
        clock.stamp()
    return (torch.stack(toks, 1), torch.stack(step_logits, 1),
            clock.step_ms())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--attn-impl", default="pallas", choices=("pallas", "jnp"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import _world_size, mesh_from_devices
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "tiny":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    mesh = mesh_from_devices(device) if _world_size() > 1 else None
    if mesh is not None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or mesh.get_rank() == 0
    mode = decode_mode(device, mesh)
    if lead:
        print(f"decode: {mode}")
        print(f"device {device} arch={cfg.name} attn_impl={cfg.attn_impl}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))

    with torch.no_grad():
        pre, step, p_layout, t_layout = serve_steps(
            cfg, args.batch, args.prompt_len, args.gen_len, mesh)
        tokens = make_prompts(cfg, args.batch, args.prompt_len, 0, device)
        inputs = make_inputs(cfg, args.batch, 0, device)
        if mesh is None:
            params = tfm.init_params(
                cfg, torch.Generator(device=device).manual_seed(0),
                device=device)
        else:
            params = sharded_params(cfg, mesh, p_layout, device)
            tokens = sh.local_block(tokens, t_layout, mesh).contiguous()
            inputs = {k: sh.local_block(v, t_layout[:1], mesh).contiguous()
                      for k, v in inputs.items()}
        _sync(device)
        t0 = time.perf_counter()
        last, cache = pre(params, {"tokens": tokens, **inputs})
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        decode = DecodeGraph(step, params, args.gen_len,
                             graph=mode == "graph", mesh=mesh)
        out, _, step_ms = decode.run(last, cache, args.prompt_len)
        if mesh is not None:       # every rank's batch block, in order
            out = sh.gather_tree({"ids": out}, {"ids": t_layout}, mesh)["ids"]
    steady = step_ms[1:] or step_ms
    if lead:
        print(f"prefill: {prefill_ms:.1f} ms (first call)")
        print(f"decode {args.gen_len} tokens: {sum(step_ms):.1f} ms; median "
              f"step {statistics.median(steady):.2f} ms; ids[0]="
              f"{out[0].tolist()}")


if __name__ == "__main__":
    main()
