"""Serving launcher: batched prefill, then greedy decode from the KV cache,
on one device (port of ``repro/launch/serve.py``, without its mesh).

Usage (on the card; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --scale full --batch 4 --prompt-len 1024 --gen-len 32

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

from repro_torch.configs import ARCH_CONFIGS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


def make_prompts(cfg, batch, prompt_len, seed=0, device=None):
    """[batch, prompt_len] int64 token ids, uniform over the vocabulary,
    drawn with numpy from ``seed``, on ``device`` (None: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    return torch.from_numpy(ids).to(device)


def prefill(cfg, params, tokens, max_len):
    """Runs the prompt through the model, filling the KV cache.  Returns
    (the last position's logits [B, V], the cache).  Only the last row
    goes through the head (the serving loop reads nothing else)."""
    out = tfm.forward_seq(cfg, params, {"tokens": tokens}, want_cache=True,
                          want_logits=False, max_cache_len=max_len)
    last = tfm.head_apply(cfg, params, out["features"][:, -1])
    return last, out["cache"]


def greedy_decode(cfg, params, cache, last_logits, start_pos, gen_len):
    """``gen_len`` greedy steps from the prefill's last logits: token i is
    argmax of the previous logits and is decoded at position start_pos + i
    (the cache is updated in place).  Returns (tokens [B, gen_len], each
    step's logits [B, gen_len, V], each step's wall ms).  On the card the step
    times come from CUDA events recorded between the steps, so the loop
    never waits for the device."""
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
        logits, cache = tfm.decode_step(cfg, params, nxt[:, None], cache, pos)
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

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "tiny":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    max_len = args.prompt_len + args.gen_len
    print(f"device {device} arch={cfg.name} attn_impl={cfg.attn_impl}")

    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(0)
        params = tfm.init_params(cfg, gen, device=device)
        tokens = make_prompts(cfg, args.batch, args.prompt_len, 0, device)
        _sync(device)
        t0 = time.perf_counter()
        last, cache = prefill(cfg, params, tokens, max_len)
        _sync(device)
        print(f"prefill: {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"(first call)")
        out, _, step_ms = greedy_decode(cfg, params, cache, last,
                                        args.prompt_len, args.gen_len)
    steady = step_ms[1:] or step_ms
    print(f"decode {args.gen_len} tokens: {sum(step_ms):.1f} ms; median "
          f"step {statistics.median(steady):.2f} ms; ids[0]="
          f"{out[0].tolist()}")


if __name__ == "__main__":
    main()
