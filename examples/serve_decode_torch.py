"""Serving example on the PyTorch/CUDA port: batched prefill, then
autoregressive decode from the KV cache, the twin of
``examples/serve_decode.py``.

Deploys a model (any ported ``--arch``, at its reduced size as in the JAX
example), prefills a batch of prompts, then decodes tokens one at a time.
The JAX example calls ``jax.jit(decode_step)`` once a token; here the step
is a ``launch.serve.DecodeGraph``: on the card it is captured once as a
CUDA graph and replayed once a token, on the CPU it runs eagerly.
``--temperature > 0`` samples ``categorical(logits / T)`` as Gumbel-max,
with the noise drawn before the loop from a seeded ``torch.Generator``.
The flags are the JAX example's, plus ``--device``.  The VLM and audio
architectures get their stub inputs as in the JAX example (standard
normal patch or frame embeddings, here drawn from a seeded
``torch.Generator`` on the device: ``launch.serve.make_inputs``).

Run:  PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma3-1b \\
          --prompt-len 32 --gen-len 16 --batch 4
      (add ``--device cpu`` on a machine without a card)
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_CONFIGS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm


def generate(cfg, params, prompts, gen_len, *, temperature=0.0, noise=None,
             inputs=None):
    """Prefill ``prompts`` [B, P] (with ``inputs``, the VLM's or the
    encoder-decoder's stub embeddings) and decode ``gen_len`` tokens
    through one ``DecodeGraph``, captured on the card and run eagerly on
    the CPU.
    ``noise`` [gen_len, B, V] (Gumbel) goes with ``temperature > 0``: token
    i is ``argmax(logits / T + noise[i])``.  Returns (ids [B, gen_len],
    prefill ms, decode ms, the loop)."""
    B, P = prompts.shape
    dev = prompts.device
    with torch.no_grad():
        t0 = time.perf_counter()
        last, cache = serve.prefill(cfg, params, prompts, P + gen_len,
                                    inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        loop = serve.DecodeGraph(
            lambda p, t, c, pos: tfm.decode_step(cfg, p, t, c, pos), params,
            gen_len, temperature=temperature,
            graph=serve.decode_mode(dev) == "graph")
        t0 = time.perf_counter()
        ids, _, _ = loop.run(last, cache, P, noise)
        decode_ms = 1e3 * (time.perf_counter() - t0)
    return ids, prefill_ms, decode_ms, loop


def main(argv=None):
    """Parse ``argv`` (None: the command line), serve, and return the
    generated ids [B, gen_len]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = tfm.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
    prompts = serve.make_prompts(cfg, args.batch, args.prompt_len, seed=1,
                                 device=device)
    inputs = serve.make_inputs(cfg, args.batch, seed=2, device=device)
    noise = (serve.gumbel_noise(args.gen_len, args.batch, cfg.vocab_size,
                                seed=7, device=device)
             if args.temperature > 0 else None)
    ids, prefill_ms, decode_ms, loop = generate(
        cfg, params, prompts, args.gen_len, temperature=args.temperature,
        noise=noise, inputs=inputs)
    print(f"prefill[{args.batch}x{args.prompt_len}]: {prefill_ms:.0f} ms "
          f"(incl. first-call kernel builds)")
    print(f"decode {args.gen_len} steps: {decode_ms:.0f} ms "
          f"({decode_ms / args.gen_len:.1f} ms/token incl. "
          f"{'the graph capture' if loop.graph_mode else 'eager steps'})")
    print("generated token ids (first sequence):", ids[0].tolist())
    return ids


if __name__ == "__main__":
    main()
