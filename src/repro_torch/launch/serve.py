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
divides, the KV cache's length over ``model``); ids are gathered and only
rank 0 prints.  A lone process serves on one device.

``--attn-impl`` defaults to ``pallas``: prefill attention runs K8a and
decode attention K9 (the JAX launcher has no flag for it and serves with
the config's ``jnp`` attention).  Weights are random, drawn from a seeded
generator on the device; prompts are drawn with numpy.  Both use seed 0.
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
from repro_torch.launch import sharding as sh
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map


def make_prompts(cfg, batch, prompt_len, seed=0, device=None):
    """[batch, prompt_len] int64 token ids, uniform over the vocabulary,
    drawn with numpy from ``seed``, on ``device`` (None: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    return torch.from_numpy(ids).to(device)


def prefill(cfg, params, tokens, max_len):
    """Runs the prompt through the model on one device, filling a KV cache
    of ``max_len`` positions: ``build_prefill_step(..., last_only=True)``.
    Returns (the last position's logits [B, V], the cache).  Only the last
    row goes through the head (the serving loop reads nothing else)."""
    B, S = tokens.shape
    pre = build_prefill_step(cfg, InputShape("serve_prefill", S, B,
                                             "prefill"),
                             max_len=max_len, last_only=True)[0]
    return pre(params, {"tokens": tokens})


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
    on_card = dev.type == "cuda"
    pos = torch.tensor(start_pos, dtype=torch.int64, device=dev)
    stamps = []

    def stamp():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
        else:
            stamps.append(time.perf_counter())

    toks, step_logits = [], []
    stamp()
    for _ in range(gen_len):
        nxt = last_logits.argmax(-1)
        toks.append(nxt)
        logits, cache = step(params, nxt[:, None], cache, pos)
        last_logits = logits[:, 0]
        step_logits.append(last_logits)
        pos += 1
        stamp()
    if on_card:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return torch.stack(toks, 1), torch.stack(step_logits, 1), step_ms


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
    max_len = args.prompt_len + args.gen_len
    mesh = mesh_from_devices(device) if _world_size() > 1 else None
    if mesh is not None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or mesh.get_rank() == 0
    if lead:
        print(f"device {device} arch={cfg.name} attn_impl={cfg.attn_impl}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))

    with torch.no_grad():
        pre, step, p_layout, t_layout = serve_steps(
            cfg, args.batch, args.prompt_len, args.gen_len, mesh)
        tokens = make_prompts(cfg, args.batch, args.prompt_len, 0, device)
        if mesh is None:
            params = tfm.init_params(
                cfg, torch.Generator(device=device).manual_seed(0),
                device=device)
        else:
            params = sharded_params(cfg, mesh, p_layout, device)
            tokens = sh.local_block(tokens, t_layout, mesh).contiguous()
        _sync(device)
        t0 = time.perf_counter()
        last, cache = pre(params, {"tokens": tokens})
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out, _, step_ms = greedy_decode(cfg, params, cache, last,
                                        args.prompt_len, args.gen_len, step)
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
