"""Production-mesh dry run: one rank's step of every (arch × input shape)
on the 16 × 16 and 2 × 16 × 16 meshes, with its memory, cost and
roofline terms (port of ``repro/launch/dryrun.py``).

The JAX package lowers and compiles each step over 512 forced host
devices.  The port cannot start 256 ranks, and needs not: it opens a
``fake`` process group of 256 ranks (512 multi-pod) in this process as
rank 0, builds the production ``DeviceMesh`` on it
(:func:`repro_torch.launch.mesh.make_production_mesh`), and runs
:func:`repro_torch.launch.steps.build_step`'s step once on rank 0's
blocks of its arguments as ``meta`` tensors, under the op recorder
(:mod:`repro_torch.analysis.records`).  ``meta`` is not a CPU fallback:
nothing is computed, only shapes flow, as JAX lowers on placeholder
devices; the fake group's collectives return at once.  The record gives
the roofline (:mod:`repro_torch.roofline`), the persistent bytes of the
rank's parameter and state blocks under the port's layout
(:mod:`repro_torch.launch.sharding`) and the high-water mark of the
step's live tensors.  A step that needs a value (a data-dependent shape,
``.item()``) cannot run on ``meta``; its record says ``status="error"``
with the op it stopped at, as JAX records a failed lowering.

The fake group is opened inside :func:`run_one` / :func:`run_superstep`
and destroyed after each; importing this module does nothing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --superstep

Records: one JSON per (arch, shape, mesh) under ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.records import OpRecorder
from repro_torch.configs import ARCH_CONFIGS, INPUT_SHAPES
from repro_torch.configs.base import ALGORITHM_NAMES, FLConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharding import local_block
from repro_torch.launch.specs import skip_reason
from repro_torch.launch.steps import build_step
from repro_torch.roofline import analyze
from repro_torch.tree import tree_leaves

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "build", "dryrun")

HBM_BYTES = 80e9           # NVIDIA H100 80GB HBM3


def default_fl() -> FLConfig:
    # the paper's main technique, conv operator (most representative)
    return FLConfig(algorithm="fedfusion", fusion_op="conv", local_steps=2)


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks in this process, as rank
    0: collectives return at once and move nothing.  Destroyed on exit,
    with the mesh module's cached subgroups."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group; "
                           "one is open already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        mesh_mod.release_groups()


def _is_struct(x) -> bool:
    return (type(x) is tuple and len(x) == 2
            and isinstance(x[1], torch.dtype))


def meta_blocks(shapes, specs, mesh, dtype=torch.float32):
    """This rank's blocks of a step's arguments as ``meta`` tensors: a
    tree of ``torch.Size`` leaves (``dtype``) or ``(shape, dtype)``
    structs, cut under the matching tree of specs (None: whole)."""
    def leaf(shape, dt, spec):
        full = torch.empty(tuple(shape), dtype=dt, device="meta")
        if spec is None or mesh is None:
            return full
        return torch.empty(local_block(full, spec, mesh).shape, dtype=dt,
                           device="meta")

    def walk(x, s):
        if isinstance(x, torch.Size):
            return leaf(x, dtype, s)
        if _is_struct(x):
            return leaf(x[0], x[1], s)
        if isinstance(x, dict):
            return {k: walk(v, None if s is None else s[k])
                    for k, v in x.items()}
        if type(x) in (list, tuple):
            return type(x)(walk(v, None if s is None else s[i])
                           for i, v in enumerate(x))
        raise TypeError(f"not a shape: {x!r}")

    return walk(shapes, specs)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _error(rec, e, recorder):
    last = recorder.record.entries[-1].name if recorder is not None \
        and recorder.record.entries else None
    rec.update(status="error", error=f"{type(e).__name__}: {e}", op=last,
               traceback=traceback.format_exc()[-2000:])


def run_one(arch: str, shape_name: str, multi_pod: bool,
            fl: FLConfig | None = None, save: bool = True,
            remat: str = "none", serve_ep: bool = False,
            shard_capacity: bool = False, moe_dispatch: str = "gather",
            tag: str = "") -> dict:
    """One rank's step of ``arch`` × ``shape_name`` on the production mesh
    (2 × 16 × 16 with ``multi_pod``), recorded on ``meta`` blocks."""
    cfg = dataclasses.replace(ARCH_CONFIGS[arch], remat=remat,
                              serve_expert_parallel=serve_ep,
                              moe_shard_capacity=shard_capacity,
                              moe_dispatch=moe_dispatch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if tag:
        rec["tag"] = tag
    if reason:
        rec.update(status="skip", reason=reason)
        return _save(rec) if save else rec

    fl = fl or default_fl()
    recorder = None
    t0 = time.time()
    try:
        from repro_torch.fl.api import make_algorithm
        world = 512 if multi_pod else 256
        with fake_group(world):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device="cpu")
            fn, shapes, in_layouts, _ = build_step(cfg, fl, shape, mesh)
            args = meta_blocks(shapes, in_layouts, mesh)
            recorder = OpRecorder()
            with recorder:
                out = fn(*args)
            t_lower = time.time() - t0
            roof = analyze(recorder.record, cfg, shape, mesh_name, world,
                           mesh,
                           two_stream=make_algorithm(fl.algorithm).two_stream)
        # the blocks that persist across steps: the state (train), the
        # weights (prefill), the weights and the cache (decode)
        persistent = _nbytes(args[0]) + (_nbytes(args[2])
                                         if shape.kind == "decode" else 0)
        memory = {"argument_size_in_bytes": _nbytes(args),
                  "persistent_size_in_bytes": persistent,
                  "output_size_in_bytes": _nbytes(out),
                  "temp_size_in_bytes": int(recorder.record.peak_bytes)}
        per_chip = (memory["argument_size_in_bytes"]
                    + memory["temp_size_in_bytes"])
        rec.update(status="ok", t_lower_s=round(t_lower, 1), memory=memory,
                   roofline=roof.to_dict(), n_ops=len(recorder.record),
                   bytes_per_chip=int(per_chip),
                   fits_80gb_hbm=bool(per_chip < HBM_BYTES))
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
        _error(rec, e, recorder)
    return _save(rec) if save else rec


def run_superstep(multi_pod: bool, compressed: bool = True,
                  save: bool = True, n_rounds: int = 8,
                  fused: bool = True, sharded_eval: bool = True) -> dict:
    """One rank's client-sharded CNN superstep on a production mesh, the
    JAX dry run's sizes: 32 clients a round over the ``pod`` / ``data``
    shards, 64 in the federation, K rounds, a top-k (0.05) uplink with
    its EF table row-sharded in the resident scratch-row layout, the
    evaluation split over the shards and folded into every round, and the
    fused one-all-reduce round (``fused=False``: the unfused oracle).
    Recorded on ``meta`` blocks over a fake group: catches layout and
    shape regressions of ``repro_torch.engine.sharded`` against the
    16 × 16 / 2 × 16 × 16 meshes on any host."""
    from repro_torch.compress import make_codec
    from repro_torch.configs import CNN_CONFIGS
    from repro_torch.core.rounds import init_global_state
    from repro_torch.engine.evaljit import make_eval_fn
    from repro_torch.engine.sharded import (client_sharding,
                                            make_sharded_superstep)
    from repro_torch.models.registry import make_bundle

    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": "cnn_mnist", "shape": "superstep", "mesh": mesh_name,
           "tag": ("topk" if compressed else "plain")
                  + ("" if fused else "-unfused")}
    recorder = None
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device="cpu")
            shard = client_sharding(mesh)
            n_clients_round, n_federation = 32, 64
            cfg = dataclasses.replace(CNN_CONFIGS["cnn_mnist"], dropout=0.0)
            fl = FLConfig(algorithm="fedavg",
                          clients_per_round=n_clients_round, local_steps=2,
                          local_batch=8,
                          uplink_codec="topk" if compressed else "identity",
                          topk_frac=0.05)
            bundle = make_bundle(cfg)
            state = init_global_state(bundle, fl, torch.Generator(), "meta")
            K, S, B = n_rounds, fl.local_steps, fl.local_batch
            c_loc = n_clients_round // shard.n_shards
            H, W, Ch = cfg.input_shape
            meta = dict(device="meta")
            batches = {"x": torch.empty((K, c_loc, S, B, H, W, Ch), **meta),
                       "y": torch.empty((K, c_loc, S, B), dtype=torch.int32,
                                        **meta)}
            sizes = torch.empty((K, c_loc), **meta)
            lrs = torch.empty((K,), **meta)
            eval_fn, test = None, ()
            if sharded_eval:
                eval_fn = make_eval_fn(bundle, fl, shard=shard)
                b_loc = 512 // shard.n_shards
                test = ({"x": torch.empty((b_loc, H, W, Ch), **meta),
                         "y": torch.empty((b_loc,), dtype=torch.int32,
                                          **meta)},
                        torch.empty((b_loc,), dtype=torch.bool, **meta))
            recorder = OpRecorder()
            if compressed:
                uplink = make_codec(fl.uplink_codec, topk_frac=fl.topk_frac)
                downlink = make_codec(fl.downlink_codec)
                uplink.bind(state["model"])
                downlink.bind(state["model"])
                n_loc = n_federation // shard.n_shards
                ef = [torch.empty((n_loc + 1,) + tuple(z.shape), **meta)
                      for z in uplink.init_state()]
                fn = make_sharded_superstep(
                    bundle, fl, "client_parallel", K, mesh, uplink=uplink,
                    downlink=downlink, eval_fn=eval_fn,
                    fused_collective=fused, shard=shard)
                cids = torch.empty((K, n_clients_round), dtype=torch.int32,
                                   **meta)
                with recorder:
                    out = fn(state, ef, state["model"], batches, sizes, lrs,
                             cids, (None, None), *test)
            else:
                fn = make_sharded_superstep(
                    bundle, fl, "client_parallel", K, mesh, eval_fn=eval_fn,
                    fused_collective=fused, shard=shard)
                with recorder:
                    out = fn(state, batches, sizes, lrs, *test)
        from repro_torch.analysis.records import (ALL_REDUCE,
                                                  count_collectives)
        rec.update(
            status="ok", t_lower_s=round(time.time() - t0, 1),
            fused_collective=fused, sharded_eval=sharded_eval,
            client_shards=shard.n_shards, clients_per_shard=c_loc,
            ef_rows_per_shard=(n_federation // shard.n_shards + 1
                               if compressed else 0),
            all_reduces=count_collectives(recorder.record, (ALL_REDUCE,)),
            out_shapes=[str(tuple(x.shape)) for x in tree_leaves(out)
                        if isinstance(x, torch.Tensor)][:4],
            n_ops=len(recorder.record))
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
        _error(rec, e, recorder)
    return _save(rec) if save else rec


def _save(rec: dict) -> dict:
    os.makedirs(ART_DIR, exist_ok=True)
    suffix = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        ART_DIR, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=sorted(ARCH_CONFIGS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--algorithm", default="fedfusion",
                    choices=sorted(ALGORITHM_NAMES))
    ap.add_argument("--fusion-op", default="conv",
                    choices=("conv", "multi", "single"))
    ap.add_argument("--remat", default="none",
                    choices=("none", "attn", "layer"),
                    help="activation-checkpoint policy (perf knob)")
    ap.add_argument("--serve-ep", action="store_true",
                    help="expert-parallel sharding for prefill/decode")
    ap.add_argument("--moe-shard-capacity", action="store_true",
                    help="shard MoE capacity dim over 'model' (perf knob)")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="all-to-all expert dispatch (perf knob)")
    ap.add_argument("--tag", default="",
                    help="suffix for the record's filename (perf variants)")
    ap.add_argument("--superstep", action="store_true",
                    help="dry-run the client-sharded federated superstep "
                         "(repro_torch.engine.sharded) on the production "
                         "meshes instead of a model step")
    args = ap.parse_args(argv)
    fl = FLConfig(algorithm=args.algorithm, fusion_op=args.fusion_op,
                  local_steps=2)

    if args.superstep:
        pods = [True] if args.multi_pod else [False, True]
        failed = False
        for mp in pods:
            # fused one-all-reduce path (the engine default) for plain +
            # topk, plus the unfused oracle layout on the compressed round
            for compressed, fused in [(False, True), (True, True),
                                      (True, False)]:
                rec = run_superstep(mp, compressed=compressed, fused=fused)
                tag = f"{rec['mesh']:8s} {rec['tag']:13s}"
                if rec["status"] == "ok":
                    print(f"superstep {tag} ok  lower={rec['t_lower_s']}s "
                          f"shards={rec['client_shards']} "
                          f"C/shard={rec['clients_per_shard']} "
                          f"ef-rows/shard={rec['ef_rows_per_shard']} "
                          f"all-reduces={rec['all_reduces']}")
                else:
                    failed = True
                    print(f"superstep {tag} ERROR {rec['error']}")
                    print(rec.get("traceback", ""))
        if failed:
            raise SystemExit(1)
        return

    if args.all:
        pods = [False, True]
        if args.single_pod_only:
            pods = [False]
        if args.multi_pod_only:
            pods = [True]
        for arch in ARCH_CONFIGS:
            for shape in INPUT_SHAPES:
                for mp in pods:
                    _report(run_one(arch, shape, mp, fl, remat=args.remat,
                                    serve_ep=args.serve_ep,
                                    shard_capacity=args.moe_shard_capacity,
                                    tag=args.tag))
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --superstep)")
    rec = run_one(args.arch, args.shape, args.multi_pod, fl,
                  remat=args.remat, serve_ep=args.serve_ep,
                  shard_capacity=args.moe_shard_capacity,
                  moe_dispatch="a2a" if args.moe_a2a else "gather",
                  tag=args.tag)
    _report(rec, verbose=True)


def _report(rec: dict, verbose: bool = False) -> None:
    tag = f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s}"
    if rec["status"] == "skip":
        print(f"{tag} SKIP ({rec['reason']})")
    elif rec["status"] == "error":
        print(f"{tag} ERROR at {rec.get('op')}: {rec['error']}")
        if verbose:
            print(rec.get("traceback", ""))
    else:
        r = rec["roofline"]
        print(f"{tag} ok  lower={rec['t_lower_s']}s "
              f"bytes/chip={rec['bytes_per_chip']/1e9:.2f}GB "
              f"t_comp={r['t_compute']*1e3:.2f}ms "
              f"t_mem={r['t_memory']*1e3:.2f}ms "
              f"t_coll={r['t_collective']*1e3:.2f}ms -> {r['bottleneck']}"
              f" useful={r['useful_ratio']:.2f}")
        if verbose:
            print(json.dumps(rec["memory"], indent=1))
            print(json.dumps(r["coll_breakdown"], indent=1))


if __name__ == "__main__":
    main()
