"""One rank of the distributed MoE CPU tests (``tests/test_torch_moe_dist.py``):
a plain process over gloo, started once per rank with

    python tests/_torch_moe_worker.py RANK WORLD INIT_FILE OUT_DIR

It imports torch and ``repro_torch`` only.  Two ranks; every rank runs the
same jobs in the same order, with a barrier after each, and writes each
result to ``OUT_DIR/<job>.r<rank>.npz`` (leaves ``leaf/i``).

Jobs, on a (2, 1) mesh (experts and tokens split over ``data``):
``moe_dispatch.moe_apply_a2a`` on the inputs in ``OUT_DIR/a2a_in.npz``
(this rank's batch block and experts) at a capacity that drops nothing,
with the gradients of sum(out * g), and at a tight capacity.  On a (1, 2)
mesh (split over ``model``): one ``launch.train`` round of reduced
granite-moe-1b and of reduced arctic-480b (dense residual, client
sequential) against the same round on one device, prefill and decode
steps of both against one device (``_torch_tp_worker.serve_job``), a
decode-graph capture on the gloo mesh (refused) and ``launch.serve``'s
first line there.
"""
import contextlib
import datetime
import io
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_worker as TPW
from repro_torch.configs import InputShape
from repro_torch.core.rounds import init_global_state
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import fl_plan
from repro_torch.launch.steps import build_train_step, tensor_parallel
from repro_torch.models import make_bundle
from repro_torch.models.moe_dispatch import moe_apply_a2a
from repro_torch.tree import tree_leaves

TOP_K, ACT = 2, "silu"
# a2a cases: capacity factor; E (8) covers every token, 1.0 drops some
A2A = {"a2a/full": 8.0, "a2a/tight": 1.0}
SHAPE = InputShape("custom_train", 16, 4, "train")
TRAIN = {"granite": "granite-moe-1b-a400m", "arctic": "arctic-480b"}
SERVE = {"granite": "granite-moe-1b-a400m", "arctic": "arctic-480b"}


def a2a_job(rank, world, out, mesh, cf):
    """This rank's blocks through ``moe_apply_a2a``: (out block, aux, and
    with a covering capacity the gradients of sum(out * g) by the x block,
    the router and this rank's experts)."""
    with np.load(os.path.join(out, "a2a_in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    E = arrays["router"].shape[1]
    e0, e1 = rank * E // world, (rank + 1) * E // world
    b = arrays["x"].shape[0] // world
    params = {"router": torch.tensor(arrays["router"], requires_grad=True)}
    for k in ("w1", "w2", "w3"):
        params[k] = torch.tensor(arrays[k][e0:e1], requires_grad=True)
    x = torch.tensor(arrays["x"][rank * b:(rank + 1) * b],
                     requires_grad=True)
    g = torch.from_numpy(arrays["g"][rank * b:(rank + 1) * b])
    mp = tensor_parallel(mesh, None).mp
    o, aux = moe_apply_a2a(params, x, mp, top_k=TOP_K, act=ACT,
                           capacity_factor=cf)
    (o * g).sum().backward()
    return [o, aux, x.grad, params["router"].grad] + [
        params[k].grad for k in ("w1", "w2", "w3")]


def train_job(name, mesh):
    cfg = TPW.cfg_of(name)
    state, records = train.train_rounds(
        cfg, TPW.fl_of("fedavg"), SHAPE, rounds=1, device="cpu", log=None,
        mesh=mesh)
    return tree_leaves(state) + [torch.tensor([r["loss"] for r in records])]


def train_single(name, plan):
    """:func:`train_job`'s round on one device with the mesh's plan."""
    cfg, fl = TPW.cfg_of(name), TPW.fl_of("fedavg")
    round_fn = build_train_step(cfg, fl, SHAPE)[0]
    state = init_global_state(make_bundle(cfg), fl,
                              torch.Generator().manual_seed(0), "cpu")
    draw, lr_at = train.round_batches(cfg, SHAPE, plan), train.round_lr(fl)
    state, metrics = round_fn(state, draw(),
                              torch.ones((plan.n_clients,)), lr_at(0))
    return tree_leaves(state) + [torch.tensor([float(
        metrics["local_loss"])])]


def gloo_capture_job(mesh):
    """A decode-graph capture on the gloo mesh raises before anything runs;
    ``launch.serve`` on it decodes eagerly and says so first."""
    try:
        serve.DecodeGraph(None, {}, 4, graph=True, mesh=mesh)
        refused = 0
    except ValueError as e:
        refused = int("gloo" in str(e))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m",
                    "--prompt-len", "12", "--gen-len", "3", "--batch", "2"])
    first = buf.getvalue().splitlines()[:1]
    eager = int(first == ["decode: eager (gloo)"] or dist.get_rank() != 0)
    return [torch.tensor([refused, eager])]


def jobs(rank, world, out, ep_mesh, tp_mesh):
    """(name, on, fn): ``on`` is "all" (a mesh job) or the rank that runs a
    one-device job."""
    from repro_torch.launch.mesh import MeshSpec
    spec = MeshSpec((1, world), ("data", "model"))
    js = [(case, "all", lambda cf=cf: a2a_job(rank, world, out, ep_mesh,
                                              cf))
          for case, cf in A2A.items()]
    single = []
    for case, name in TRAIN.items():
        js.append((f"train/{case}", "all",
                   lambda n=name: train_job(n, tp_mesh)))
        single.append((f"train/{case}/single",
                       lambda n=name: train_single(
                           n, fl_plan(TPW.cfg_of(n), SHAPE, spec))))
    for case, name in SERVE.items():
        js.append((f"serve/{case}", "all",
                   lambda n=name: TPW.serve_job(n, 4, tp_mesh)["leaves"]))
        single.append((f"serve/{case}/single",
                       lambda n=name: TPW.serve_job(n, 4, None)["leaves"]))
    js.append(("gloo_capture", "all", lambda: gloo_capture_job(tp_mesh)))
    return js + [(n, i % world, fn) for i, (n, fn) in enumerate(single)]


def save(out, job, rank, leaves):
    np.savez(os.path.join(out, f"{job.replace('/', '__')}.r{rank}.npz"),
             **{f"leaf/{i}": t.detach().cpu().numpy()
                for i, t in enumerate(leaves)})


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    ep_mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    tp_mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    done = []
    for name, on, fn in jobs(rank, world, out, ep_mesh, tp_mesh):
        if on == "all" or on == rank:
            save(out, name, rank, fn())
            done.append(name)
        dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "done": done}), flush=True)


if __name__ == "__main__":
    main()
