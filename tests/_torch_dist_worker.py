"""One rank of the client-sharded engine's CPU tests
(``tests/test_torch_sharded.py``): a plain process over gloo, started once
per rank with

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE OUT_DIR

It imports torch and ``repro_torch`` only.  Every rank runs the same jobs
in the same order (the sharded runs issue their collectives together),
with a barrier after each job; a job that runs on one device only runs on
one rank (``single`` jobs are spread over the ranks).  Each rank writes
each result it computed to ``OUT_DIR/<job>.r<rank>.npz``: the final
state's leaves, the ``CommLog`` history and bytes, and the run's stats.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.chaos import ChaosConfig
from repro_torch.checkpoint.io import load_tree
from repro_torch.configs import CNN_MNIST, FLConfig, get_config
from repro_torch.core.rounds import init_global_state
from repro_torch.data import (FederatedDataset, artificial_noniid_partition,
                              class_images, source_partition, token_stream)
from repro_torch.fl.server import run_federated
from repro_torch.launch.mesh import make_engine_mesh, make_mesh
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

NARROW = dict(input_shape=(12, 12, 1), conv_channels=(4, 8), fc_units=(16,))
N_CLIENTS, N_TEST, ROUNDS, SEED = 8, 40, 4, 1
BASE = dict(clients_per_round=4, local_steps=2, local_batch=4, lr=0.05)
CASES = {
    "plain": ("client_parallel", dict()),
    "topk": ("client_parallel", dict(uplink_codec="topk", topk_frac=0.1)),
    "quant+downtopk": ("client_parallel",
                       dict(uplink_codec="int8", downlink_codec="topk",
                            topk_frac=0.1)),
    "fusion-topk": ("client_parallel",
                    dict(algorithm="fedfusion", fusion_op="conv",
                         uplink_codec="topk", topk_frac=0.1)),
    "topk-seq": ("client_sequential",
                 dict(uplink_codec="topk", topk_frac=0.1)),
    # an LM bundle (smollm-135m reduced, vocab 64, the plain K8a-K8c); its
    # random init starts at a loss near 100, and at lr 0.05 the rounds
    # amplify the all-reduce's summation order past the tolerance (19 of
    # 1.2 M entries by up to 2.8e-6 after 4 rounds); at 0.02 it trains
    "lm": ("client_parallel", dict(lr=0.02)),
}
LM_CASES = ("lm",)
LM_VOCAB, LM_SEQ = 64, 16
CHAOS_KW = dict(speed_sigma=1.0, jitter=0.2, dropout=0.3, truncation=0.3,
                seed=7)
# the cases each world size runs against the single-device engine
SHARDED = {2: ("plain", "topk", "topk-seq", "quant+downtopk",
               "fusion-topk", "lm"),
           4: ("topk", "fusion-topk")}
# the cases whose fused run is held to the unfused one
UNFUSED = {2: ("plain", "topk", "topk-seq", "quant+downtopk",
               "fusion-topk", "lm"),
           4: ("topk",)}
JAX_CASES = ("fusion-topk", "topk-seq")   # S = 2, against JAX's loop


def bundle(case=None):
    if case in LM_CASES:
        return make_bundle(dataclasses.replace(
            get_config("smollm-135m").reduced(), attn_impl="pallas",
            vocab_size=LM_VOCAB))
    return make_bundle(dataclasses.replace(CNN_MNIST, **NARROW))


def lm_parts():
    toks, src = token_stream(64, LM_SEQ, vocab=LM_VOCAB,
                             n_sources=N_CLIENTS, seed=0)
    test, _ = token_stream(8, LM_SEQ, vocab=LM_VOCAB, n_sources=N_CLIENTS,
                           seed=1)
    return source_partition(toks, src, N_CLIENTS), {"tokens": test}


def parts():
    x, y = class_images(10, shape=NARROW["input_shape"], seed=0,
                        template_seed=0)
    xt, yt = class_images(-(-N_TEST // 10), shape=NARROW["input_shape"],
                          seed=1, template_seed=0)
    return (artificial_noniid_partition(x, y, N_CLIENTS, shards_per_client=2),
            {"x": xt[:N_TEST], "y": yt[:N_TEST]})


def data(chaos=False, case=None):
    p, test = lm_parts() if case in LM_CASES else parts()
    return FederatedDataset(p, test, seed=0,
                            chaos=ChaosConfig(**CHAOS_KW) if chaos else None)


def fl_of(case, **kw):
    mode, ckw = CASES[case]
    return mode, FLConfig(**{**BASE, **ckw, **kw})


def run(case, *, mesh=None, chaos=False, fl_kw=None, **kw):
    mode, fl = fl_of(case, **(fl_kw or {}))
    opts = dict(rounds=ROUNDS, seed=SEED, mode=mode, eval_every=2,
                eval_examples=64, superstep_rounds=2)
    opts.update(kw)
    return run_federated(bundle(case), fl, data(chaos, case), mesh=mesh,
                         device="cpu", **opts)


def jax_state(case, out):
    _, fl = fl_of(case)
    like = init_global_state(bundle(), fl, torch.Generator().manual_seed(0),
                             "cpu")
    return load_tree(os.path.join(out, f"s0_{case}.npz"), like)


def save(out, job, rank, res):
    stats = {k: v for k, v in res.stats.items()
             if isinstance(v, (int, float, bool, str, type(None)))}
    leaves = {f"leaf/{i}": t.detach().cpu().numpy()
              for i, t in enumerate(tree_leaves(res.global_state))}
    np.savez(os.path.join(out, f"{job}.r{rank}.npz"),
             history=json.dumps(res.comm.history),
             bytes=np.array([res.comm.bytes_up, res.comm.bytes_down]),
             stats=json.dumps(stats), **leaves)


def jobs(world, out, mesh):
    """(name, on, fn): ``on`` is "all" (a sharded run: every rank) or the
    rank that runs a one-device job."""
    single = []

    def one(name, fn):
        single.append((name, fn))

    js = []
    for case in SHARDED[world]:
        js.append((case, "all", lambda c=case: run(c, mesh=mesh)))
        one(f"{case}/single", lambda c=case: run(c))
    for case in UNFUSED[world]:
        js.append((f"{case}/unfused", "all",
                   lambda c=case: run(c, mesh=mesh, fused_collective=False)))
    if world == 2:
        for case in JAX_CASES:
            js.append((f"{case}/jax", "all",
                       lambda c=case: run(c, mesh=mesh,
                                          global_state=jax_state(c, out))))
        js.append(("topk/paged", "all",
                   lambda: run("topk", mesh=mesh, ef_store="host")))
        for flag in (True, False):
            js.append((f"topk/eval-{flag}", "all",
                       lambda f=flag: run("topk", mesh=mesh, eval_every=1,
                                          sharded_eval=f)))
        part = dict(participation="deadline", over_provision=1.5)
        js.append(("deadline", "all",
                   lambda: run("topk", mesh=mesh, chaos=True, fl_kw=part)))
        one("deadline/single", lambda: run("topk", chaos=True, fl_kw=part))
        ctrl = dict(controller="ef_ratio")
        js.append(("ef_ratio", "all",
                   lambda: run("topk", mesh=mesh, fl_kw=ctrl)))
        one("ef_ratio/single", lambda: run("topk", fl_kw=ctrl))
        # checkpoints across layouts: saved on one layout after 4 rounds,
        # resumed to 8 on the other; the oracle is the same two phases on
        # one device
        ck = dict(eval_every=4, superstep_rounds=3, checkpoint_every=2)

        def phase(d, rounds, m):
            return run("topk", mesh=m, rounds=rounds,
                       checkpoint_dir=os.path.join(out, d), **ck)

        # a checkpoint the JAX package wrote after 2 rounds (one copy a
        # layout), resumed to 4 on the mesh and on one device
        js.append(("jaxckpt", "all", lambda: run(
            "topk", mesh=mesh, checkpoint_dir=os.path.join(out, "jax_m"),
            checkpoint_from_jax=True)))
        one("jaxckpt/single", lambda: run(
            "topk", checkpoint_dir=os.path.join(out, "jax_s"),
            checkpoint_from_jax=True))
        # rank 0 decides the calibrated chunk size and alone writes the log
        js.append(("topk/auto", "all",
                   lambda: run("topk", mesh=mesh, superstep_rounds="auto")))
        js.append(("topk/runlog", "all", lambda: run(
            "topk", mesh=mesh, runlog=os.path.join(out, "run.jsonl"))))
        js.append(("ckpt/m2s-1", "all", lambda: phase("m2s", 4, mesh)))
        js.append(("ckpt/m2s", 0, lambda: phase("m2s", 8, None)))
        js.append(("ckpt/s2m-1", 1, lambda: phase("s2m", 4, None)))
        js.append(("ckpt/s2m", "all", lambda: phase("s2m", 8, mesh)))
        one("ckpt/oracle", lambda: (phase("oracle", 4, None),
                                    phase("oracle", 8, None))[1])
    else:
        pod = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        js.append(("topk/pod", "all", lambda: run("topk", mesh=pod)))
    return js + [(n, i % world, fn) for i, (n, fn) in enumerate(single)]


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_engine_mesh(device="cpu")
    for name, on, fn in jobs(world, out, mesh):
        if on == "all" or on == rank:
            res = fn()
            if not name.endswith("-1"):
                save(out, name.replace("/", "__"), rank, res)
        dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main()
