"""One rank of the mesh-family CPU tests (``tests/test_torch_mesh.py``): a
plain process over gloo, started once per rank with

    python tests/_torch_mesh_worker.py RANK WORLD INIT_FILE OUT_DIR

It imports torch and ``repro_torch`` only.  Two ranks make a (1, 2) mesh
(``data``, ``model``: the model split) and a (2, 1) one (FSDP: leaves and
rows split over ``data``); four ranks a (2, 2) one (both).  Every rank
runs the same mesh jobs in the same order; a one-device job runs on one
rank (they are spread over the ranks, after the mesh jobs, without
waits), and a barrier ends the run.  Each rank writes each result it computed
to ``OUT_DIR/<job>.r<rank>.npz``, and prints its jobs' seconds as it
ends.

Jobs: every JAX architecture's train, prefill and decode steps built on
each mesh (``launch.steps``; nothing runs); the launcher's round loop
(``launch.train.train_rounds``) on a mesh and its one-device counterpart
at the mesh's plan; prefill and teacher-forced decode steps
(``launch.steps.build_prefill_step`` / ``build_serve_step``, the stub
frame and patch embeddings beside the prompts) on a mesh and on one
device.
"""
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import load_tree
from repro_torch.configs import (ARCH_CONFIGS, FLConfig, InputShape,
                                 get_config)
from repro_torch.core.rounds import init_global_state
from repro_torch.launch import serve
from repro_torch.launch import sharding as sh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import fl_plan
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models import make_bundle
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
AXES = ("data", "model")
SEQ, ROUNDS = 16, 1
ARCH = {"mamba": "mamba2-130m", "rglru": "recurrentgemma-9b",
        "whisper": "whisper-large-v3", "vlm": "qwen2-vl-7b",
        "arctic": "arctic-480b", "arctic-a2a": "arctic-480b",
        "dense": "smollm-135m"}
# round cases by mesh: family, algorithm, global batch.  On (1, 2) the
# model is split (client_parallel families: one client); on (2, 1) and
# (2, 2) the client_sequential families (and smollm-135m set to that
# mode, the dense model) run the FSDP round: 4 clients in turn, 2 rows
# each split over data, or 1 row each (global batch 4) that every data
# rank computes; arctic-480b also with the all-to-all dispatch (its
# experts left split over data, the tokens sent to them) at a capacity
# that drops no token, against the gather dispatch on one device
TRAIN = {
    (1, 2): {"mamba/fedavg": ("mamba", "fedavg", 4),
             "rglru/fedfusion": ("rglru", "fedfusion", 8),
             "whisper/fedmmd": ("whisper", "fedmmd", 4),
             "vlm/fedavg": ("vlm", "fedavg", 8)},
    (2, 1): {"vlm/fedmmd": ("vlm", "fedmmd", 8),
             "rglru/fedavg": ("rglru", "fedavg", 8),
             "arctic/fedavg": ("arctic", "fedavg", 8),
             "arctic-a2a/fedavg": ("arctic-a2a", "fedavg", 8),
             "dense/fedfusion": ("dense", "fedfusion", 8),
             "dense/fedl2/b1": ("dense", "fedl2", 4)},
    (2, 2): {"vlm/fedmmd": ("vlm", "fedmmd", 8),
             "rglru/fedfusion": ("rglru", "fedfusion", 8),
             "arctic/fedmmd": ("arctic", "fedmmd", 8),
             "dense/fedl2": ("dense", "fedl2", 8),
             "mamba/fedmmd": ("mamba", "fedmmd", 4)},
}
JAX_CASE = ((2, 2), "vlm/fedmmd")    # starts from JAX's state
# serve cases by mesh: family, batch.  Prompts of PROMPT tokens and STEPS
# forced steps into caches of MAX_LEN; whisper's 16 frames are split 8 + 8
# over model on (1, 2), and 4 a rank over data and model at batch 1 on
# (2, 2)
SERVE = {(1, 2): {"mamba/b2": ("mamba", 2), "rglru/b2": ("rglru", 2),
                  "whisper/b2": ("whisper", 2), "vlm/b2": ("vlm", 2)},
         (2, 2): {"whisper/b1": ("whisper", 1), "rglru/b2": ("rglru", 2),
                  "vlm/b1": ("vlm", 1)}}
PROMPT, STEPS, MAX_LEN = 12, 4, 24


def cfg_of(family, mesh=True):
    """The family's reduced config; ``mesh=False``: its one-device
    counterpart (the gather dispatch in place of the all-to-all)."""
    cfg = dataclasses.replace(get_config(ARCH[family]).reduced(),
                              attn_impl="pallas")
    if family == "dense":
        cfg = dataclasses.replace(cfg, fl_mode="client_sequential")
    if family == "arctic-a2a":
        cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts),
                                  moe_dispatch="a2a" if mesh else "gather")
    return cfg


def fl_of(algorithm):
    return FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                    lr=0.05)


def tag(mesh_shape):
    return "x".join(map(str, mesh_shape))


def s0(mesh_shape, case, out):
    if (mesh_shape, case) != JAX_CASE:
        return None     # the launcher's own draw from seed 0
    family, algorithm, _ = TRAIN[mesh_shape][case]
    like = init_global_state(make_bundle(cfg_of(family)), fl_of(algorithm),
                             torch.Generator().manual_seed(0), "cpu")
    return load_tree(os.path.join(out, "s0_jax.npz"), like)


def train_job(mesh_shape, case, out, mesh):
    family, algorithm, B = TRAIN[mesh_shape][case]
    state, records = train.train_rounds(
        cfg_of(family), fl_of(algorithm), InputShape("t", SEQ, B, "train"),
        rounds=ROUNDS, device="cpu", global_state=s0(mesh_shape, case, out),
        log=None, mesh=mesh)
    return {"leaves": tree_leaves(state),
            "losses": [r["loss"] for r in records]}


def train_single(mesh_shape, case, out):
    """:func:`train_job`'s rounds on one device with the mesh's plan: the
    same clients and draws, every client on this rank."""
    family, algorithm, B = TRAIN[mesh_shape][case]
    cfg, fl = cfg_of(family, mesh=False), fl_of(algorithm)
    shape = InputShape("t", SEQ, B, "train")
    from repro_torch.launch.mesh import MeshSpec
    plan = fl_plan(cfg, shape, MeshSpec(mesh_shape, AXES))
    round_fn = build_train_step(cfg, fl, shape)[0]
    state = s0(mesh_shape, case, out)
    if state is None:
        state = init_global_state(make_bundle(cfg), fl,
                                  torch.Generator().manual_seed(0), "cpu")
    draw, lr_at = train.round_batches(cfg, shape, plan), train.round_lr(fl)
    nex = torch.ones((plan.n_clients,), dtype=torch.float32)
    losses = []
    for r in range(ROUNDS):
        state, metrics = round_fn(state, draw(), nex, lr_at(r))
        losses.append(float(metrics["local_loss"]))
    return {"leaves": tree_leaves(state), "losses": losses}


def serve_job(family, B, mesh):
    """Prefill, then STEPS decode steps fed drawn tokens; logits [B,
    STEPS + 1, V] (the prefill's last row first), whole on every rank."""
    cfg = cfg_of(family)
    pre, _, pre_in, _ = build_prefill_step(
        cfg, InputShape("p", PROMPT, B, "prefill"), mesh, max_len=MAX_LEN,
        last_only=True)
    step, _, step_in, _ = build_serve_step(
        cfg, InputShape("d", MAX_LEN, B, "decode"), mesh)
    toks = torch.from_numpy(np.random.default_rng(B).integers(
        0, cfg.vocab_size, (B, PROMPT + STEPS)))
    inputs = serve.make_inputs(cfg, B, 0, "cpu")
    if mesh is None:
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    else:
        params = serve.sharded_params(cfg, mesh, step_in[0], "cpu")
        toks = sh.local_block(toks, pre_in[1]["tokens"], mesh).contiguous()
        inputs = {k: sh.local_block(v, pre_in[1][k], mesh).contiguous()
                  for k, v in inputs.items()}
    with torch.no_grad():
        last, cache = pre(params, {"tokens": toks[:, :PROMPT], **inputs})
        rows = [last]
        pos = torch.tensor(PROMPT)
        for i in range(STEPS):
            logits, cache = step(params, toks[:, PROMPT + i:PROMPT + i + 1],
                                 cache, pos)
            rows.append(logits[:, 0])
            pos += 1
    logits = torch.stack(rows, 1)
    if mesh is not None:      # every data rank's batch block, in order
        logits = sh.gather_tree({"x": logits}, {"x": pre_in[1]["tokens"]},
                                mesh)["x"]
    return {"leaves": [logits], "losses": []}


def build_job(mesh):
    """Every architecture's train, prefill and decode steps on ``mesh``
    (reduced, FedAvg), nothing run: 1 for each whose train layouts are
    ``param_shardings(..., fsdp=)`` of its mode."""
    built = []
    for name in sorted(ARCH_CONFIGS):
        cfg = get_config(name).reduced()
        _, args, lin, lout = build_train_step(
            cfg, fl_of("fedavg"), InputShape("t", SEQ, 8, "train"), mesh)
        want = sh.param_shardings(mesh, args[0],
                                  fsdp=cfg.fl_mode == "client_sequential")
        build_prefill_step(cfg, InputShape("p", PROMPT, 2, "prefill"), mesh,
                           max_len=MAX_LEN)
        build_serve_step(cfg, InputShape("d", MAX_LEN, 2, "decode"), mesh)
        built.append(int(lin[0] == want and lout[0] == want))
    return {"leaves": [torch.tensor(built)], "losses": []}


def save(out, job, rank, res):
    np.savez(os.path.join(out, f"{job.replace('/', '__')}.r{rank}.npz"),
             losses=np.array(res["losses"], np.float64),
             **{f"leaf/{i}": t.detach().cpu().numpy()
                for i, t in enumerate(res["leaves"])})


def jobs(world, out, meshes):
    """(name, on, fn): ``on`` is "all" (a mesh job) or the rank that runs a
    one-device job."""
    js, single = [], []
    for shape, mesh in meshes.items():
        t = tag(shape)
        js.append((f"build/{t}", "all", lambda m=mesh: build_job(m)))
        for case in TRAIN[shape]:
            js.append((f"train/{t}/{case}", "all",
                       lambda s=shape, c=case, m=mesh: train_job(s, c, out,
                                                                 m)))
            single.append((f"train/{t}/{case}/single",
                           lambda s=shape, c=case: train_single(s, c, out)))
        for case, (family, B) in SERVE.get(shape, {}).items():
            js.append((f"serve/{t}/{case}", "all",
                       lambda f=family, b=B, m=mesh: serve_job(f, b, m)))
            single.append((f"serve/{t}/{case}/single",
                           lambda f=family, b=B: serve_job(f, b, None)))
    return js + [(n, i % world, fn) for i, (n, fn) in enumerate(single)]


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    meshes = {s: make_mesh(s, AXES, device="cpu") for s in MESHES[world]}
    done = []
    for name, on, fn in jobs(world, out, meshes):
        if on == "all" or on == rank:    # the one-device jobs need no wait
            t0 = time.perf_counter()
            save(out, name, rank, fn())
            done.append([name, round(time.perf_counter() - t0, 2)])
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "done": done}), flush=True)


if __name__ == "__main__":
    main()
