#!/usr/bin/env python3
"""Times K1 (the FedMMD term), K2 (fusion conv), K8a (flash attention
forward), K8b / K8c (the flash backward), K9 (flash-decode), K3 (a
quantized message's encode) and K5 (top-k select) of one or more source
trees on one NVIDIA GPU, in turns, for A/B comparisons.

    python3 kernel_ab.py [--root DIR[:NAME=VALUE,...] ...]
                         [--only mk_mmd|fusion_conv|flash_fwd|flash_bwd|
                                 flash_decode|quant_encode|topk_select]

Each ``--root`` is a checkout (or a ``git archive``) holding
``src/repro_torch``; the default is this script's own. ``DIR:NAME=VALUE``
times a variant of DIR: a copy of its ``src/repro_torch`` under this
checkout's ``build/variants/`` with the one ``constexpr`` NAME of its
``csrc/*.cu`` set to VALUE (several pairs separated by commas; for
instance ``DIR:kTopkUnroll=4``). Give the trees in
the order they should run (for instance parent, change, change, parent):
the trees' kernels are built first, all at once, each into its tree's own
``build/``; then each tree runs in a process of its own, one after the
other, and prints one JSON line per measurement:

- ``mk_mmd`` at (n, m, d) = (10, 10, 64) (the CNN's pooled features)
  and (8, 8, 576) (the LM's): the tree's ``ops.mk_mmd2`` forward and dx
  (y detached, as FedMMD's global features are), whichever route the tree
  takes (three Gram sums and eager ops, or the fused term), as wall ms
  and as device kernels and device microseconds a term under
  ``torch.profiler``;
- ``fusion_conv`` at (T, C) = (490, 64) (the CNN's training shape, with
  the kernel's device microseconds a launch from ``torch.profiler``),
  (100,352, 64) (eval) and (8,192, 576) (smollm-135m's LM fusion): the
  wrapper's time, ``torch.mm(torch.cat((f_g, f_l), -1), w)``'s and the
  bound;
- ``flash_fwd`` at ``chip_smoke.FLASH_CASES``: K8a's time and device
  microseconds a launch, ``scaled_dot_product_attention``'s, the bound and
  ``flash_attn.fwd_plan``'s modelled makespan where the tree has it;
  (for both, a shape the tree refuses, such as a head dim it has no
  kernel for, is reported as refused);
- ``flash_bwd`` at ``chip_smoke.FLASH_BWD_CASES``: K8b's and K8c's times
  and device microseconds a launch, the float32 backward of
  ``scaled_dot_product_attention`` (all three gradients) and each kernel's
  bound;
- ``flash_decode`` at ``chip_smoke.DECODE_CASES`` with the cache full:
  ``ops.gqa_flash_decode`` as a decode step calls it (the valid length a
  0-d int64 tensor on the card), as wall ms over 8 input sets (larger than
  L2 together), device ops and device microseconds a call under
  ``torch.profiler``, and the bound (a shape the tree refuses is reported
  as refused);
- ``quant_encode``: ``QuantCodec(bits).bind(delta).encode(delta, None,
  offsets)`` on a CNN_MNIST-shaped delta at int8 and int4, as the
  reference loop and the engine call it, as wall ms a message over 8
  messages, device ops and device microseconds a message, and the bound
  (x and the offsets read once, the codes and scales written once);
- ``topk_select``: K5 as ``topk_select_cuda`` and its one-call yardstick
  ``F.hardshrink(x, nextafter(t, 0))`` (bit-equal on NaN-free inputs) at
  CNN_MNIST's FC leaf (``chip_smoke.FC_LEAF``, 8 input sets cycled) and at
  ``chip_smoke.TOPK_BIG`` (smollm-135m's token embedding, 2 sets), each
  as device microseconds a call under ``torch.profiler``, back-to-back
  wall ms and the bound, with the tree's K5 schedule where it reports
  one; and the wall ms of both at CNN_MNIST's 5,120-element ``fc2`` leaf,
  where the host sets the time.

Every result is checked against a plain version on the same inputs (the
MMD term and its dx against autograd through the formula in float64 at
rtol 1e-5 / 1e-4, K2 within 1e-5 of the output's largest element, K8a
within ``chip_smoke.ATTN_TOL``, K8b / K8c within ``chip_smoke.BWD_TOL``
of each gradient's largest element, K9 within ``chip_smoke.ATTN_TOL``, the
quantized message's codes and scales equal to the same codec's on the CPU,
K5 equal to its plain version and to the yardstick, all bitwise
repeatable), and a check that fails makes the run exit
non-zero. The first line names the card and
its power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

K2_SHAPES = [(490, 64), (100352, 64), (8192, 576)]
MMD_SHAPES = [(10, 10, 64), (8, 8, 576)]


def emit(**fields):
    print(json.dumps(fields), flush=True)


def device_us(torch, fn, name, launches=50):
    """Mean device microseconds of the activities named ``name`` over
    ``launches`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    return sum(spans) / len(spans) if spans else None


def time_fusion_conv(torch, fusion_conv, tag):
    gen = torch.Generator().manual_seed(0)
    ok = True
    for T, C in K2_SHAPES:
        fg = torch.randn(T, C, generator=gen).cuda()
        fl = torch.randn(T, C, generator=gen).cuda()
        w = (torch.randn(2 * C, C, generator=gen) / math.sqrt(2 * C)).cuda()
        got = fusion_conv.fusion_conv_cuda(fg, fl, w)
        want = fusion_conv.fusion_conv_plain(fg, fl, w)
        again = fusion_conv.fusion_conv_cuda(fg, fl, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        bound_ms, bound_by = cs.bound(*cs.fusion_conv_work(T, C))
        line = dict(
            tree=tag, kernel="fusion_conv", shape=[T, C], abs_err=err,
            tol=tol, bitwise_repeat=bool(torch.equal(got, again)),
            kernel_ms=cs.time_ms(torch, lambda: fusion_conv.fusion_conv_cuda(
                fg, fl, w)),
            library_ms=cs.time_ms(torch, lambda: torch.mm(
                torch.cat((fg, fl), -1), w)),
            bound_ms=bound_ms, bound_by=bound_by)
        if T == 490:
            line["device_us"] = device_us(
                torch, lambda: fusion_conv.fusion_conv_cuda(fg, fl, w),
                "fusion_conv")
            line["library_device_us"] = device_us(
                torch, lambda: torch.mm(torch.cat((fg, fl), -1), w), "gemm")
        emit(**line)
        ok &= err <= tol and line["bitwise_repeat"]
    return ok


def mmd2_oracle(torch, x, y):
    """MMD^2 in float64 by autograd-able ops (the repository's formula:
    sigma the stop-grad mean of the unclamped cross d2 + 1e-8, each Gram
    sum over d2 clamped at 0)."""
    x, y = x.double(), y.double()

    def sq(a, b):
        return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                - 2.0 * (a @ b.T))

    dxy = sq(x, y)
    sigma = dxy.mean().detach() + 1e-8

    def kmean(d2):
        return sum(torch.exp(-d2.clamp_min(0.0) / (2.0 * w * sigma))
                   for w in cs.WIDTHS).mean() / len(cs.WIDTHS)

    return kmean(sq(x, x)) + kmean(sq(y, y)) - 2.0 * kmean(dxy)


def time_mk_mmd(torch, ops, tag):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(6)
    ok = True
    for n, m, d in MMD_SHAPES:
        x = torch.randn(n, d, generator=gen).cuda()
        y = (0.5 * torch.randn(m, d, generator=gen) + 1.0).cuda()
        xr = x.clone().requires_grad_(True)

        def term():
            value = ops.mk_mmd2(xr, y, cs.WIDTHS)
            return value, torch.autograd.grad(value, xr)[0]

        value, dx = term()
        value2, dx2 = term()
        xd = x.double().requires_grad_(True)
        want = mmd2_oracle(torch, xd, y)
        (want_dx,) = torch.autograd.grad(want, xd)
        err = abs(value.item() - want.item())
        dx_err = (dx.double() - want_dx).abs().max().item()
        good = (err <= 1e-5 * abs(want.item()) + 1e-6
                and dx_err <= 1e-4 * want_dx.abs().max().item()
                and torch.equal(value, value2) and torch.equal(dx, dx2))
        term()
        torch.cuda.synchronize()
        calls = 50
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                term()
            torch.cuda.synchronize()
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                spans.append(us)
                by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        emit(tree=tag, kernel="mk_mmd", shape=[n, m, d], abs_err=err,
             dx_abs_err=dx_err, ok=good,
             term_ms=cs.time_ms(torch, term),
             device_ops_per_term=len(spans) / calls,
             device_us_per_term=sum(spans) / calls,
             top_device_us_per_term={k: us / calls for k, us in top})
        ok &= good
    return ok


def time_flash_fwd(torch, flash_attn, tag):
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(3)
    ok = True
    for case, B, S, H, KV, hd, window, causal in cs.FLASH_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen).cuda()
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        kw = dict(window=window, causal=causal)

        def call():
            return flash_attn.flash_fwd_cuda(q, k, v, **kw)

        try:
            (o, lse), (o2, lse2) = call(), call()
        except ValueError as err:
            emit(tree=tag, kernel="flash_fwd", case=case,
                 shape=[B, S, H, KV, hd], refused=str(err)[:160])
            continue
        o_p, lse_p = flash_attn.flash_fwd_plain(q, k, v, **kw)
        err = max((o - o_p).abs().max().item(),
                  (lse - lse_p).abs().max().item())
        repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
        del o, lse, o2, lse2, o_p, lse_p
        bound_ms, bound_by = cs.bound(*cs.flash_fwd_work(B, S, H, KV, hd,
                                                        window, causal))
        line = dict(tree=tag, kernel="flash_fwd", case=case,
                    shape=[B, S, H, KV, hd], window=window, causal=causal,
                    abs_err=err,
                    tol=cs.ATTN_TOL, bitwise_repeat=repeat,
                    kernel_ms=cs.time_ms(torch, call, launches=10, repeats=9),
                    device_us=device_us(torch, call, "flash_fwd", 20),
                    bound_ms=bound_ms, bound_by=bound_by)
        if hasattr(flash_attn, "fwd_plan"):
            plan = flash_attn.fwd_plan(B, S, H, KV, hd, causal, window)
            line["plan"] = dict(makespan=plan.makespan, ideal=plan.ideal)
        if S == 1024:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = None
            if window is not None:
                pos = torch.arange(S, device=q.device)
                mask = ((pos[None, :] <= pos[:, None])
                        & ((pos[:, None] - pos[None, :]) < window))
            line["library_ms"] = cs.time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True),
                launches=10, repeats=9)
            del qt, kt, vt
        emit(**line)
        ok &= err <= cs.ATTN_TOL and repeat
    return ok


def time_flash_bwd(torch, flash_attn, tag):
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(4)
    ok = True
    for case, B, S, H, KV, hd, window, causal in cs.FLASH_BWD_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen).cuda()
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        do = randn(B, S, H, hd)
        kw = dict(window=window, causal=causal)
        try:
            o, lse = flash_attn.flash_fwd_cuda(q, k, v, **kw)
        except ValueError as err:
            emit(tree=tag, kernel="flash_bwd", case=case,
                 shape=[B, S, H, KV, hd], refused=str(err)[:160])
            continue
        dcap = flash_attn.flash_dcap(do, o, KV)

        def dq_call():
            return flash_attn.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, **kw)

        def dkv_call():
            return flash_attn.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw)

        got = (dq_call(), *dkv_call())
        again = (dq_call(), *dkv_call())
        want = flash_attn.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want)]
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        line = dict(tree=tag, kernel="flash_bwd", case=case,
                    shape=[B, S, H, KV, hd], window=window, causal=causal,
                    rel_err=dict(zip(("dq", "dk", "dv"), rel)),
                    bitwise_repeat=repeat)
        work = cs.flash_bwd_work(B, S, H, KV, hd, window, causal)
        for name, call in (("flash_bwd_dq", dq_call),
                           ("flash_bwd_dkv", dkv_call)):
            line[name] = dict(zip(("bound_ms", "bound_by"),
                                  cs.bound(*work[name])),
                              kernel_ms=cs.time_ms(torch, call, launches=10,
                                                   repeats=9),
                              device_us=device_us(torch, call, name, 20))
        if S == 1024:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            mask = None
            if window is not None:
                pos = torch.arange(S, device=q.device)
                mask = ((pos[None, :] <= pos[:, None])
                        & ((pos[:, None] - pos[None, :]) < window))
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            line["library_ms"] = cs.time_ms(
                torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True),
                launches=5, repeats=7)
            del out, qt, kt, vt
        emit(**line)
        ok &= max(rel) <= cs.BWD_TOL and repeat
    return ok


def time_flash_decode(torch, ops, decode_attn, tag):
    gen = torch.Generator().manual_seed(5)
    ok = True
    sets = 8                        # 8 caches together exceed the L2 cache
    for case, B, L, H, KV, hd, _ in cs.DECODE_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen).cuda()
        qs = [randn(B, 1, H, hd) for _ in range(sets)]
        ks = [randn(B, L, KV, hd) for _ in range(sets)]
        vs = [randn(B, L, KV, hd) for _ in range(sets)]
        valid = torch.tensor(L, device="cuda")     # as decode_step has it

        def call(i):
            return ops.gqa_flash_decode(qs[i], ks[i], vs[i], valid)

        line = dict(tree=tag, kernel="flash_decode", case=case,
                    shape=[B, L, H, KV, hd], valid_len=L)
        try:
            got, again = call(0), call(0)
        except ValueError as err:
            emit(**line, refused=str(err)[:120])
            continue
        want = decode_attn.flash_decode_plain(qs[0], ks[0], vs[0], L)
        err = (got - want).abs().max().item()
        repeat = torch.equal(got, again)
        ops_per_call, us = cs.device_per_call(torch, call)
        bound_ms, bound_by = cs.bound(*cs.flash_decode_work(B, L, H, KV, hd))
        emit(**line, abs_err=err, tol=cs.ATTN_TOL, bitwise_repeat=repeat,
             wall_ms=cs.time_ms(torch, call, sets=sets),
             device_ops_per_call=ops_per_call, device_us_per_call=us,
             bound_ms=bound_ms, bound_by=bound_by,
             bound_share_of_device=bound_ms * 1e3 / us)
        ok &= err <= cs.ATTN_TOL and repeat
    return ok


def time_quant_encode(torch, QuantCodec, make_bundle, CNN_MNIST, tag):
    from repro_torch.tree import tree_leaves, tree_map
    template = make_bundle(CNN_MNIST).init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(8)
    sizes = [t.numel() for t in tree_leaves(template)]
    ok = True
    for bits in (8, 4):
        trees = [tree_map(lambda t: torch.randn(t.shape, generator=gen)
                          .cuda(), template) for _ in range(8)]
        codec = QuantCodec(bits).bind(trees[0])
        noise = [[torch.rand(n, generator=gen).cuda()
                  for n in codec.noise_sizes()] for _ in range(8)]

        def call(i):
            return codec.encode(trees[i], None, noise[i])

        got, again = call(0)[0], call(0)[0]
        cpu = QuantCodec(bits).bind(tree_map(lambda t: t.cpu(), trees[0]))
        want = cpu.encode(tree_map(lambda t: t.cpu(), trees[0]), None,
                          [u.cpu() for u in noise[0]])[0]
        equal = all(torch.equal(g["q"].cpu(), w["q"])
                    and torch.equal(g["scale"].cpu(), w["scale"])
                    for g, w in zip(got, want))
        repeat = all(torch.equal(g["q"], a["q"])
                     and torch.equal(g["scale"], a["scale"])
                     for g, a in zip(got, again))
        ops_per_call, us = cs.device_per_call(torch, call)
        code_b = sum(n if bits == 8 else (n + 1) // 2 for n in sizes)
        n_bytes = 8 * sum(sizes) + code_b + 4 * len(sizes)
        bound_ms, bound_by = cs.bound(n_bytes, 5 * sum(sizes))
        emit(tree=tag, kernel="quant_encode", bits=bits, leaves=len(sizes),
             elements=sum(sizes), equal_to_cpu=equal, bitwise_repeat=repeat,
             wire_bytes=codec.nbytes(got),
             wall_ms=cs.time_ms(torch, call, sets=8),
             device_ops_per_message=ops_per_call,
             device_us_per_message=us, bound_ms=bound_ms,
             bound_by=bound_by, bound_share_of_device=bound_ms * 1e3 / us)
        ok &= equal and repeat
    return ok


def time_topk_select(torch, compress_pack, tag):
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(9)
    ok = True
    for n, sets in [(cs.FC_LEAF, 8), (cs.TOPK_BIG, 2)]:
        xs = [torch.randn(n, generator=gen).cuda() for _ in range(sets)]
        ts = [x.abs().kthvalue(n - n // 16 + 1).values.reshape(1)
              for x in xs]
        for x, t in zip(xs, ts):
            x[0], x[-1] = -t[0], t[0]       # ties at t: kept
        lambds = [cs.hardshrink_lambd(torch, t) for t in ts]

        def kern(i):
            return compress_pack.topk_select_cuda(xs[i], ts[i])

        def lib(i):
            return F.hardshrink(xs[i], lambds[i])

        got, again = kern(0), kern(0)
        equal = torch.equal(got, compress_pack.topk_select_plain(xs[0],
                                                                 ts[0]))
        lib_equal = torch.equal(got, lib(0))
        repeat = torch.equal(got, again)
        del got, again
        ops_per_call, us = cs.device_per_call(torch, kern, sets=sets)
        lib_ops, lib_us = cs.device_per_call(torch, lib, sets=sets)
        bound_ms, bound_by = cs.bound(*cs.codec_work("topk_select", n))
        line = dict(tree=tag, kernel="topk_select", n=n, sets=sets,
                    equal=equal, hardshrink_equal=lib_equal,
                    bitwise_repeat=repeat,
                    device_ops_per_call=ops_per_call, device_us_per_call=us,
                    library_device_ops_per_call=lib_ops,
                    library_device_us_per_call=lib_us,
                    wall_ms=cs.time_ms(torch, kern, sets=sets),
                    library_wall_ms=cs.time_ms(torch, lib, sets=sets),
                    bound_ms=bound_ms, bound_by=bound_by,
                    bound_share_of_device=bound_ms * 1e3 / us)
        if hasattr(compress_pack, "topk_schedule"):
            line["schedule"] = compress_pack.topk_schedule(n)
        emit(**line)
        ok &= equal and lib_equal and repeat
        del xs
    n = 5120                                # CNN_MNIST's fc2 weight
    x = torch.randn(n, generator=gen).cuda()
    t = x.abs().kthvalue(n - n // 16 + 1).values.reshape(1)
    lambd = cs.hardshrink_lambd(torch, t)
    emit(tree=tag, kernel="topk_select", n=n,
         wall_ms=cs.time_ms(torch, lambda: compress_pack.topk_select_cuda(
             x, t), launches=200),
         library_wall_ms=cs.time_ms(torch, lambda: F.hardshrink(x, lambd),
                                    launches=200))
    return ok


def variant_tree(spec):
    """The source tree a ``--root`` names: DIR itself, or for
    ``DIR:NAME=VALUE,...`` a copy of DIR's ``src/repro_torch`` under this
    checkout's ``build/variants/`` with each ``constexpr`` NAME of its
    ``csrc/*.cu`` (defined exactly once) set to VALUE."""
    root, _, pairs = spec.partition(":")
    if not pairs:
        return root
    dest = HERE / "build" / "variants" / re.sub(r"[^\w.=-]+", "_", spec)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(Path(root) / "src" / "repro_torch",
                    dest / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = dest / "src" / "repro_torch" / "csrc"
    for pair in pairs.split(","):
        name, _, value = pair.partition("=")
        pat = re.compile(rf"(constexpr\s+[\w ]+?\b{re.escape(name)}\s*=\s*)"
                         r"[^;]+;")
        hits = 0
        for f in sorted(csrc.glob("*.cu")):
            text, k = pat.subn(lambda m: m.group(1) + value + ";",
                               f.read_text())
            if k:
                f.write_text(text)
            hits += k
        if hits != 1:
            sys.exit(f"kernel_ab: constexpr {name} found {hits} times "
                     f"under {csrc}, not once")
    return str(dest)


def run_one(root, only, build_only, tag):
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch.cuda finds no CUDA device")
    src = Path(root).resolve() / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        sys.exit(f"kernel_ab: {src / 'repro_torch'} not found")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import (build, compress_pack, decode_attn,
                                     flash_attn, fusion_conv, ops)
    if build_only:
        sources = {"mk_mmd": ("gram_sum",), "fusion_conv": ("fusion_conv",),
                   "flash_fwd": ("flash_attn",),
                   "flash_bwd": ("flash_attn", "flash_attn_bwd"),
                   "flash_decode": ("decode_attn",),
                   "quant_encode": ("compress_pack",),
                   "topk_select": ("compress_pack",)}
        build.build(dict.fromkeys(s for name in only or sources
                                  for s in sources[name]))
        emit(tree=tag, ptxas={n: cs.ptxas_summary(log)
                              for n, log in build.BUILD_LOG.items()})
        return
    ok = True
    if not only or "mk_mmd" in only:
        ok &= time_mk_mmd(torch, ops, tag)
    if not only or "fusion_conv" in only:
        ok &= time_fusion_conv(torch, fusion_conv, tag)
    if not only or "flash_fwd" in only:
        ok &= time_flash_fwd(torch, flash_attn, tag)
    if not only or "flash_bwd" in only:
        ok &= time_flash_bwd(torch, flash_attn, tag)
    if not only or "flash_decode" in only:
        ok &= time_flash_decode(torch, ops, decode_attn, tag)
    if not only or "quant_encode" in only:
        from repro_torch.compress import QuantCodec
        from repro_torch.configs import CNN_MNIST
        from repro_torch.models import make_bundle
        ok &= time_quant_encode(torch, QuantCodec, make_bundle, CNN_MNIST,
                                tag)
    if not only or "topk_select" in only:
        ok &= time_topk_select(torch, compress_pack, tag)
    if not ok:
        sys.exit(f"kernel_ab: a kernel of {tag} disagrees with its plain "
                 "version")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="a source tree to time, or DIR:NAME=VALUE,... "
                         "for a variant of it (repeatable; default: this "
                         "checkout)")
    ap.add_argument("--only", action="append",
                    choices=("mk_mmd", "fusion_conv", "flash_fwd",
                             "flash_bwd", "flash_decode", "quant_encode",
                             "topk_select"),
                    help="time these kernel families only (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_one(args.one, args.only, args.build_only,
                       args.tag or args.one)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch.cuda finds no CUDA device")
    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]), flush=True)
    specs = args.root or [str(HERE)]
    trees = {spec: variant_tree(spec) for spec in dict.fromkeys(specs)}
    only = [a for name in args.only or () for a in ("--only", name)]
    builds = {spec: subprocess.Popen([sys.executable, __file__, "--one",
                                      tree, "--tag", spec, "--build-only",
                                      *only])
              for spec, tree in trees.items()}
    failed = [spec for spec, proc in builds.items() if proc.wait()]
    if failed:
        sys.exit(f"kernel_ab: the build failed for {failed}")
    for spec in specs:
        rc = subprocess.run([sys.executable, __file__, "--one", trees[spec],
                             "--tag", spec, *only]).returncode
        if rc:
            failed.append(spec)
    if failed:
        sys.exit(f"kernel_ab: failed on {failed}")


if __name__ == "__main__":
    main()
