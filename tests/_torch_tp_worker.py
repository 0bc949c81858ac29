"""One rank of the tensor-parallel CPU tests (``tests/test_torch_tp.py``): a
plain process over gloo, started once per rank with

    python tests/_torch_tp_worker.py RANK WORLD INIT_FILE OUT_DIR

It imports torch and ``repro_torch`` only.  Two ranks form a (1, 2) mesh
(``data``, ``model``), four a (2, 2) one.  Every rank runs the same jobs
in the same order, with a barrier after each; a one-device job runs on
one rank (they are spread over the ranks).  Each rank writes each result
it computed to ``OUT_DIR/<job>.r<rank>.npz``.

Jobs: the launcher's round loop (``launch.train.train_rounds``) on the
mesh, and its one-device counterpart at the mesh's plan
(``launch.steps.build_train_step`` without a mesh, fed
``launch.train.round_batches``); prefill and teacher-forced
decode steps (``launch.steps.build_prefill_step`` / ``build_serve_step``)
on the mesh and on one device; at two ranks, ``launch.train.main(
["--engine", ...])`` through its multi-rank engine mesh.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import load_tree
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.core.rounds import init_global_state
from repro_torch.launch import sharding as sh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import sharded_params
from repro_torch.launch.specs import fl_plan
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models import make_bundle
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves

MESHES = {2: (1, 2), 4: (2, 2)}
SHAPE = InputShape("custom_train", 16, 4, "train")
ROUNDS = 2
# round cases: model, algorithm (fusion conv); smollm-135m reduced is
# head-parallel at m = 2 (4 / 2 heads), gemma3-1b reduced gathers (its one
# KV head of 64 columns is split mid-head)
TRAIN = {"smollm/fedavg": ("smollm-135m", "fedavg"),
         "smollm/fedfusion": ("smollm-135m", "fedfusion"),
         "smollm/fedmmd": ("smollm-135m", "fedmmd"),
         "gemma/fedavg": ("gemma3-1b", "fedavg")}
JAX_CASE = "smollm/fedfusion"      # starts from JAX's state, held to JAX
# serve cases: model, batch.  Prompts of 60 and 6 forced steps (positions
# 60 .. 65: gemma3-1b's 64-token ring wraps at 64) into caches of 160
# (model rank 1's global slice, 80 .. 159, stays empty); batch 1 on the
# (2, 2) mesh splits L over data and model
SERVE = {2: {"smollm/b4": ("smollm-135m", 4), "gemma/b4": ("gemma3-1b", 4)},
         4: {"smollm/b4": ("smollm-135m", 4), "gemma/b4": ("gemma3-1b", 4),
             "gemma/b1": ("gemma3-1b", 1)}}
PROMPT, STEPS, MAX_LEN = 60, 6, 160
ENGINE_ARGS = ["--engine", "--device", "cpu", "--rounds", "2", "--seq-len",
               "16", "--global-batch", "2"]


def cfg_of(name):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, attn_impl="pallas")


def fl_of(algorithm):
    return FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                    lr=0.05)


def s0(case, out):
    name, algorithm = TRAIN[case]
    if case != JAX_CASE:
        return None     # the launcher's own draw from seed 0
    like = init_global_state(make_bundle(cfg_of(name)), fl_of(algorithm),
                             torch.Generator().manual_seed(0), "cpu")
    return load_tree(os.path.join(out, "s0_jax.npz"), like)


def train_job(case, out, mesh):
    name, algorithm = TRAIN[case]
    state, records = train.train_rounds(
        cfg_of(name), fl_of(algorithm), SHAPE, rounds=ROUNDS, device="cpu",
        global_state=s0(case, out), log=None, mesh=mesh)
    return {"leaves": tree_leaves(state),
            "losses": [r["loss"] for r in records]}


def train_single(case, out, plan):
    """:func:`train_job`'s rounds on one device with the mesh's ``plan``:
    the same clients and draws, every client on this rank."""
    name, algorithm = TRAIN[case]
    cfg, fl = cfg_of(name), fl_of(algorithm)
    round_fn = build_train_step(cfg, fl, SHAPE)[0]
    state = s0(case, out)
    if state is None:
        state = init_global_state(make_bundle(cfg), fl,
                                  torch.Generator().manual_seed(0), "cpu")
    draw, lr_at = train.round_batches(cfg, SHAPE, plan), train.round_lr(fl)
    nex = torch.ones((plan.n_clients,), dtype=torch.float32)
    losses = []
    for r in range(ROUNDS):
        state, metrics = round_fn(state, draw(), nex, lr_at(r))
        losses.append(float(metrics["local_loss"]))
    return {"leaves": tree_leaves(state), "losses": losses}


def serve_tokens(cfg, B):
    rng = np.random.default_rng(B)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, PROMPT + STEPS)))


def serve_job(name, B, mesh):
    """Prefill, then STEPS decode steps fed the drawn tokens; logits [B,
    STEPS + 1, V] (the prefill's last row first), whole on every rank."""
    cfg = cfg_of(name)
    pre, _, pre_in, _ = build_prefill_step(
        cfg, InputShape("p", PROMPT, B, "prefill"), mesh, max_len=MAX_LEN,
        last_only=True)
    step, _, step_in, _ = build_serve_step(
        cfg, InputShape("d", MAX_LEN, B, "decode"), mesh)
    toks = serve_tokens(cfg, B)
    if mesh is None:
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    else:
        params = sharded_params(cfg, mesh, step_in[0], "cpu")
        toks = sh.local_block(toks, pre_in[1]["tokens"], mesh).contiguous()
    with torch.no_grad():
        last, cache = pre(params, {"tokens": toks[:, :PROMPT]})
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


def engine_job(rank, world):
    os.environ["WORLD_SIZE"], os.environ["RANK"] = str(world), str(rank)
    res = train.main(ENGINE_ARGS)
    return {"leaves": tree_leaves(res.global_state), "losses": [],
            "bytes": [res.comm.bytes_up, res.comm.bytes_down]}


def save(out, job, rank, res):
    np.savez(os.path.join(out, f"{job.replace('/', '__')}.r{rank}.npz"),
             losses=np.array(res["losses"], np.float64),
             bytes=np.array(res.get("bytes", []), np.int64),
             **{f"leaf/{i}": t.detach().cpu().numpy()
                for i, t in enumerate(res["leaves"])})


def jobs(rank, world, out, mesh):
    """(name, on, fn): ``on`` is "all" (a mesh job) or the rank that runs a
    one-device job."""
    from repro_torch.launch.mesh import MeshSpec
    plan = fl_plan(cfg_of("smollm-135m"), SHAPE,
                   MeshSpec(MESHES[world], ("data", "model")))
    js, single = [], []
    for case in TRAIN:
        js.append((f"train/{case}", "all",
                   lambda c=case: train_job(c, out, mesh)))
        single.append((f"train/{case}/single",
                       lambda c=case: train_single(c, out, plan)))
    for case, (name, B) in SERVE[world].items():
        js.append((f"serve/{case}", "all",
                   lambda n=name, b=B: serve_job(n, b, mesh)))
        single.append((f"serve/{case}/single",
                       lambda n=name, b=B: serve_job(n, b, None)))
    if world == 2:
        js.append(("engine", "all", lambda: engine_job(rank, world)))
    return js + [(n, i % world, fn) for i, (n, fn) in enumerate(single)]


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(MESHES[world], ("data", "model"), device="cpu")
    done = []
    for name, on, fn in jobs(rank, world, out, mesh):
        if on == "all" or on == rank:
            save(out, name, rank, fn())
            done.append(name)
        dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "done": done}), flush=True)


if __name__ == "__main__":
    main()
