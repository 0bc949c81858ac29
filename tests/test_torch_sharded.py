"""The client-sharded engine (``repro_torch.engine.sharded``) on the CPU:
gloo process groups of 2 and 4 ranks, against the port's single-device
engine, against the JAX package's reference loop, and its numpy helpers
against the JAX package's.

Each world size is one group of plain worker processes
(``tests/_torch_dist_worker.py``, one a rank, rendezvous through a file in
``tmp_path``) that runs every case in one session and writes its results
to npz files; the module fixture starts both groups together and runs
JAX's reference loops while they train.  Tolerances:

* sharded vs single device: rtol 2e-5 / atol 1e-6 on the final state
  (the all-reduce sums the clients in another order), identical
  ``CommLog`` bytes and keys, per-round metrics to rtol 1e-4 / atol 1e-5
  (the contract of the JAX package's ``tests/test_engine.py``);
* sharded vs JAX's reference loop: rtol 1e-4 / atol 1e-5 and identical
  bytes (the port's parity tolerance, ``tests/test_torch_engine.py``);
* fused vs unfused collectives: equal at S = 2, where every element's sum
  is a + b in either order; allclose at rtol 1e-6 at S = 4, where gloo's
  ring sums an element in an order that depends on its place in the
  buffer (``repro_torch.core.aggregate.fused_psum``);
* replicated outputs: equal on every rank (an all-reduce gives every rank
  the same bits).
"""
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from repro.checkpoint.io import ef_disk_layout as j_ef_disk_layout
from repro.checkpoint.io import insert_scratch_rows as j_insert
from repro.checkpoint.io import strip_scratch_rows as j_strip
from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.engine.efstore import _patch_map as j_patch_map
from repro.engine.efstore import plan_chunk_static as j_plan
from repro.engine.evaljit import pad_eval_batch as j_pad_eval_batch
from repro.fl.server import run_federated_reference as j_ref
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.checkpoint.io import (ef_disk_layout, insert_scratch_rows,
                                       save_tree, strip_scratch_rows)
from repro_torch.core.aggregate import ClientSharding, fused_psum
from repro_torch.engine.efstore import _patch_map, plan_chunk_static
from repro_torch.engine.evaljit import pad_eval_batch
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch.sharding import client_block, ef_table_block
from repro_torch.tree import tree_leaves, tree_unflatten

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
WORKER_TIMEOUT_S = 300
WORLDS = (2, 4)


class Group:
    """One worker group's outcome and saved results."""

    def __init__(self, out, rcs, logs):
        self.out, self.rcs, self.logs = out, rcs, logs

    def load(self, job, rank=None):
        pat = os.path.join(self.out, "{}.r{}.npz".format(
            job.replace("/", "__"), "*" if rank is None else rank))
        found = sorted(glob.glob(pat))
        assert found, f"no result for {job!r} (rank {rank}): see the logs"
        with np.load(found[0]) as z:
            n = sum(k.startswith("leaf/") for k in z.files)
            return {"leaves": [z[f"leaf/{i}"] for i in range(n)],
                    "history": json.loads(str(z["history"])),
                    "bytes": tuple(int(b) for b in z["bytes"]),
                    "stats": json.loads(str(z["stats"]))}

    def ranks_of(self, job):
        return sorted(int(p.rsplit(".r", 1)[1][:-4]) for p in glob.glob(
            os.path.join(self.out, job.replace("/", "__") + ".r*.npz")))


def _j_setup(case):
    mode, fl = W.fl_of(case)
    kw = {**W.BASE, **W.CASES[case][1]}
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **W.NARROW))
    return mode, jb, JFL(**kw)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Start the 2- and 4-rank groups, run JAX's reference loops while
    they train, then collect both."""
    root = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = {}
    parts, test = W.parts()
    for world in sorted(WORLDS, reverse=True):
        out = root / f"w{world}"
        out.mkdir()
        for case in W.JAX_CASES:      # JAX's initial states, converted
            _, jb, jfl = _j_setup(case)
            s0 = jax.tree.map(np.asarray, j_init_global_state(
                jb, jfl, jax.random.PRNGKey(W.SEED)))
            save_tree(str(out / f"s0_{case}.npz"), state_from_numpy(s0))
        if world == 2:     # a JAX checkpoint after 2 rounds, one copy a run
            mode, jb, jfl = _j_setup("topk")
            j_ref(jb, jfl, JFD(parts, test, seed=0), rounds=2, seed=W.SEED,
                  mode=mode, eval_every=2, eval_examples=64,
                  checkpoint_dir=str(out / "jax_m"))
            shutil.copytree(out / "jax_m", out / "jax_s")
        procs[world] = (out, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(out / "rdzv"),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)])
    try:
        refs = {}
        for case in W.JAX_CASES:
            mode, jb, jfl = _j_setup(case)
            refs[case] = j_ref(jb, jfl, JFD(parts, test, seed=0),
                               rounds=W.ROUNDS, seed=W.SEED, mode=mode,
                               eval_every=2, eval_examples=64)
        done = {}
        for world, (out, ps) in procs.items():
            logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in ps]
            done[world] = Group(str(out), [p.returncode for p in ps], logs)
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return done, refs


def _close(single, sharded, rtol=2e-5, atol=1e-6):
    """The sharded-vs-single contract: state allclose, bytes exact, the
    per-round metrics equal to float tolerance."""
    for a, b in zip(single["leaves"], sharded["leaves"]):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    assert single["bytes"] == sharded["bytes"]
    assert len(single["history"]) == len(sharded["history"])
    for h1, h2 in zip(single["history"], sharded["history"]):
        assert set(h1) == set(h2)
        for k in h1:
            if isinstance(h1[k], float):
                np.testing.assert_allclose(h2[k], h1[k], rtol=1e-4,
                                           atol=1e-5)
            else:
                assert h1[k] == h2[k], k


def _equal(a, b):
    assert len(a["leaves"]) == len(b["leaves"])
    for x, y in zip(a["leaves"], b["leaves"]):
        np.testing.assert_array_equal(x, y)
    assert a["history"] == b["history"] and a["bytes"] == b["bytes"]


@pytest.mark.parametrize("world", WORLDS)
def test_worker_group_finished(groups, world):
    g = groups[0][world]
    assert g.rcs == [0] * world, "\n".join(g.logs)
    assert all(f"rank {r}: done" in log for r, log in enumerate(g.logs))


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in W.SHARDED[w]])
def test_sharded_engine_matches_single_device(groups, world, case):
    g = groups[0][world]
    sharded = g.load(case)
    _close(g.load(f"{case}/single"), sharded)
    st = sharded["stats"]
    assert st["client_shards"] == world
    assert st["fused_collective"] and st["sharded_eval"]
    assert g.load(f"{case}/single")["stats"]["client_shards"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_outputs_equal_on_every_rank(groups, world):
    g = groups[0][world]
    jobs = [n for n in {os.path.basename(p).rsplit(".r", 1)[0]
                        for p in glob.glob(os.path.join(g.out, "*.r0.npz"))}
            if len(g.ranks_of(n)) == world]
    assert len(jobs) >= len(W.SHARDED[world]) + len(W.UNFUSED[world])
    for job in jobs:
        first = g.load(job, 0)
        for r in range(1, world):
            _equal(first, g.load(job, r))


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in W.UNFUSED[w]])
def test_fused_collective_matches_unfused(groups, world, case):
    """Bit for bit at S = 2; allclose at S = 4 (module docstring)."""
    g = groups[0][world]
    fused, unfused = g.load(case), g.load(f"{case}/unfused")
    assert fused["stats"]["fused_collective"]
    assert not unfused["stats"]["fused_collective"]
    if world == 2:
        _equal(fused, unfused)
    else:
        _close(unfused, fused, rtol=1e-6, atol=1e-7)


def _n_leaves(case):
    """(model leaves, extra-state leaves, EF leaves) of a case."""
    model = len(tree_leaves(W.bundle(case).init(
        torch.Generator().manual_seed(0))))
    _, fl = W.fl_of(case)
    extras = 1 if fl.algorithm == "fedfusion" else 0      # fusion {"w"}
    ef = model if fl.uplink_codec == "topk" else 0
    return model, extras, ef


@pytest.mark.parametrize("world,case,fused", [
    (w, c, f) for w in WORLDS for c in W.UNFUSED[w] for f in (True, False)])
def test_collectives_per_chunk(groups, world, case, fused):
    """Fused: K + 1 all-reduces a K-round chunk (the prologue and one a
    round).  Unfused, a round makes one for the weight total, one a leaf
    of the model (or delta) sum and of the extras, one for the loss and
    two an EF leaf (gather and scatter).  Each boundary eval adds one
    (the sharded evaluator's masked sums)."""
    g = groups[0][world]
    st = g.load(case if fused else f"{case}/unfused")["stats"]
    chunks = -(-W.ROUNDS // 2)
    evals = W.ROUNDS // 2
    assert st["chunks"] == chunks
    if fused:
        want = W.ROUNDS + chunks + evals
    else:
        model, extras, ef = _n_leaves(case)
        want = W.ROUNDS * (1 + model + extras + 1 + 2 * ef) + evals
    assert st["collectives"] == want


@pytest.mark.parametrize("case", W.JAX_CASES)
def test_sharded_engine_matches_jax_reference(groups, case):
    """S = 2 from the converted JAX initial state vs the JAX package's
    reference loop."""
    done, refs = groups
    got, jres = done[2].load(f"{case}/jax"), refs[case]
    _, fl = W.fl_of(case)
    like = W.init_global_state(W.bundle(), fl,
                               torch.Generator().manual_seed(0), "cpu")
    tree = state_to_numpy(tree_unflatten(
        like, [torch.from_numpy(x) for x in got["leaves"]]))
    want = jax.tree.map(np.asarray, jres.global_state)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for g_, w_ in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype
        np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-5)
    hist = jres.comm.history
    assert len(got["history"]) == len(hist)
    for ht, hj in zip(got["history"], hist):
        assert set(ht) == set(hj)
        for k in ("round", "bytes_up", "bytes_down", "bytes_up_ideal",
                  "cum_bytes_up"):
            assert ht[k] == hj[k], k
        np.testing.assert_allclose(ht["local_loss"], hj["local_loss"],
                                   rtol=1e-4, atol=1e-5)
        if "loss" in hj:
            np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-4,
                                       atol=1e-5)
            assert abs(ht["acc"] - hj["acc"]) <= 1.0 / W.N_TEST + 1e-6
    assert got["bytes"] == (jres.comm.bytes_up, jres.comm.bytes_down)


def test_paged_ef_equals_dense_on_the_mesh(groups):
    g = groups[0][2]
    _equal(g.load("topk"), g.load("topk/paged"))
    assert g.load("topk/paged")["stats"]["ef_store"] == "host"


def test_sharded_eval_matches_replicated_eval(groups):
    """Evaluation every round: the split batch leaves training alone
    (state equal) and its metrics agree with the whole-batch evaluator's
    to float tolerance."""
    g = groups[0][2]
    shd, repl = g.load("topk/eval-True"), g.load("topk/eval-False")
    for a, b in zip(shd["leaves"], repl["leaves"]):
        np.testing.assert_array_equal(a, b)
    _close(repl, shd)
    assert all("acc" in h for h in shd["history"])
    assert shd["stats"]["sharded_eval"] and not repl["stats"]["sharded_eval"]


@pytest.mark.parametrize("job", ["ckpt/m2s", "ckpt/s2m"],
                         ids=["sharded-to-single", "single-to-sharded"])
def test_checkpoint_resumes_across_layouts(groups, job):
    """Saved after 4 rounds on one layout (ef.npz compact), resumed to 8
    on the other: equal, to the sharded tolerance, to the same two phases
    on one device."""
    g = groups[0][2]
    got = g.load(job)
    _close(g.load("ckpt/oracle"), got)
    assert len(got["history"]) == 4


def test_jax_checkpoint_resumes_onto_the_mesh(groups):
    """A checkpoint the JAX package wrote after 2 rounds (its compact
    ef.npz), converted and given its scratch rows, resumes to 4 rounds on
    two ranks as on one device."""
    g = groups[0][2]
    got, want = g.load("jaxckpt"), g.load("jaxckpt/single")
    _close(want, got)
    assert len(got["history"]) == 2


def test_rank_zero_decides_the_chunk_size_and_writes_the_log(groups):
    g = groups[0][2]
    auto = [g.load("topk/auto", r) for r in range(2)]
    assert auto[0]["stats"]["chunk_rounds"] == \
        auto[1]["stats"]["chunk_rounds"] >= 8
    _equal(g.load("topk"), auto[0])        # chunking changes no value
    logged = [g.load("topk/runlog", r)["stats"] for r in range(2)]
    assert logged[0]["runlog"].endswith("run.jsonl")
    assert "runlog" not in logged[1]
    assert os.path.exists(logged[0]["runlog"])


@pytest.mark.parametrize("job", ["deadline", "ef_ratio"])
def test_participation_and_controller_match_single_device(groups, job):
    g = groups[0][2]
    sharded = g.load(job)
    _close(g.load(f"{job}/single"), sharded)
    if job == "deadline":
        assert sharded["stats"]["participation"] == "deadline"
        assert sharded["stats"]["round_cohort"] == 6
        assert all("sim_time" in h for h in sharded["history"])
    else:
        assert sharded["stats"]["controller"] == "ef_ratio"
        assert all("level" in h for h in sharded["history"])


def test_pod_data_mesh_matches_data_mesh(groups):
    """(pod=2, data=2, model=1) splits the clients as (data=4, model=1)
    does (positions are row-major over pod, data), so the runs agree to
    the fused all-reduce's rounding."""
    g = groups[0][4]
    pod = g.load("topk/pod")
    _close(g.load("topk"), pod, rtol=1e-6, atol=1e-7)
    assert pod["stats"]["client_shards"] == 4


# --------------------------------------------------------------------------
# numpy helpers, exactly JAX's
# --------------------------------------------------------------------------

def _cids(seed, k, c, n=12):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, c, replace=False) for _ in range(k)])


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("seed,k,c", [(0, 1, 4), (1, 3, 4), (2, 8, 8)])
def test_plan_and_patch_map_match_jax_on_a_mesh(seed, k, c, n_shards):
    prev, cur = _cids(seed, k, c), _cids(seed + 10, k, c)
    got = plan_chunk_static(cur, n_shards, index=1)
    want = j_plan(cur, n_shards, index=1)
    for f in ("vcids", "uniq", "slots", "rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.p_loc, got.page_rows, got.n_shards) == \
        (want.p_loc, want.page_rows, want.n_shards)
    gp = _patch_map(plan_chunk_static(prev, n_shards, index=0), got)
    wp = j_patch_map(j_plan(prev, n_shards, index=0), want)
    for a, b in zip(gp, wp):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_scratch_row_helpers_match_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    compact = [rng.standard_normal((8, 5)).astype(np.float32),
               rng.standard_normal((8, 3, 2)).astype(np.float32)]
    resident = insert_scratch_rows(compact, n_shards)
    rows = 8 // n_shards
    for a, b, c in zip(resident, j_insert(compact, n_shards), compact):
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] == (rows + 1) * n_shards
        # rank p's block: its owned rows, then a zero scratch row
        for p in range(n_shards):
            block = ef_table_block(a, ClientSharding(
                ("data",), (n_shards,), position=p))
            np.testing.assert_array_equal(block[:rows],
                                          c[p * rows:(p + 1) * rows])
            assert not block[rows:].any()
    for a, b in zip(strip_scratch_rows(resident, n_shards),
                    j_strip(resident, n_shards)):
        np.testing.assert_array_equal(a, b)
    for a, b, c in zip(ef_disk_layout(resident, n_shards=n_shards)
                       if n_shards > 1 else ef_disk_layout(compact),
                       j_ef_disk_layout(resident if n_shards > 1
                                        else compact, n_shards=n_shards),
                       compact):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="divide"):
        insert_scratch_rows([np.zeros((6, 2), np.float32)], 4)


@pytest.mark.parametrize("n,max_examples,n_shards", [
    (40, 64, 2), (40, 64, 4), (5, 64, 3), (100, 48, 4), (7, 2048, 1)])
def test_pad_eval_batch_shard_matches_jax(n, max_examples, n_shards):
    rng = np.random.default_rng(n)
    batch = {"x": rng.standard_normal((n, 4, 4, 1)).astype(np.float32),
             "y": rng.integers(0, 10, n).astype(np.int32)}
    got, gmask = pad_eval_batch(batch, max_examples, "cpu", shard=n_shards)
    want, wmask = j_pad_eval_batch(batch, max_examples, shard=n_shards)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert len(gmask) % n_shards == 0
    # the positional split covers the bucket once
    shards = [ClientSharding(("data",), (n_shards,), position=p)
              for p in range(n_shards)]
    parts = [client_block(gmask, s, axis=0) for s in shards]
    assert torch.equal(torch.cat(parts), gmask)


def test_fused_psum_refuses_a_mixed_dtype_tree():
    shard = ClientSharding(("data",), (2,), position=0)
    with pytest.raises(TypeError, match="single-dtype"):
        fused_psum({"a": torch.zeros(2), "b": torch.zeros(2,
                                                          dtype=torch.int32)},
                   shard)
    assert shard.collectives == 0
    tree = {"a": torch.ones(3)}
    assert fused_psum(tree, None) is tree


# --------------------------------------------------------------------------
# one rank, in this process: the shard-aware path is the single-device one
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_engine_mesh
    return make_engine_mesh(device="cpu")


@pytest.mark.parametrize("case,kw", [
    ("plain", dict(sharded_eval=True)), ("topk", {}),
    ("topk", dict(ef_store="host")), ("topk", dict(fused_collective=False)),
    ("quant+downtopk", {}), ("topk-seq", {})],
    ids=["plain-sharded-eval", "topk", "topk-paged", "topk-unfused",
         "quant+downtopk", "topk-seq"])
def test_one_rank_shard_path_equals_single_device(host_mesh, case, kw):
    """``run_federated_engine(shard=...)`` at one rank (what the one-card
    host runs on NCCL): every all-reduce sums one term, so the run equals
    the single-device engine exactly, eval included."""
    from repro_torch.engine import run_federated_engine
    mode, fl = W.fl_of(case)
    opts = dict(rounds=W.ROUNDS, seed=W.SEED, mode=mode, eval_examples=64,
                superstep_rounds=2, device="cpu")
    store = {k: v for k, v in kw.items() if k == "ef_store"}
    single = run_federated_engine(W.bundle(), fl, W.data(), **store, **opts)
    shard = ClientSharding(("data",), (1,),
                           group=host_mesh.get_group("data"), position=0)
    got = run_federated_engine(W.bundle(), fl, W.data(), shard=shard,
                               **{"sharded_eval": False, **kw}, **opts)
    for a, b in zip(tree_leaves(single.global_state),
                    tree_leaves(got.global_state)):
        assert torch.equal(a, b)
    assert single.comm.history == got.comm.history
    model, extras, ef = _n_leaves(case)
    evals = W.ROUNDS * kw.get("sharded_eval", False)
    if kw.get("fused_collective", True):
        want = W.ROUNDS + W.ROUNDS // 2 + evals
    else:
        want = W.ROUNDS * (1 + model + extras + 1 + 2 * ef)
    assert got.stats["collectives"] == shard.collectives == want
    assert got.stats["client_shards"] == 1


def test_sharded_builders_refuse_a_one_shard_mesh(host_mesh):
    from repro_torch.engine import (client_sharding, make_sharded_eval,
                                    make_sharded_superstep)
    assert client_sharding(host_mesh) is None
    with pytest.raises(ValueError, match="1-shard"):
        make_sharded_superstep(W.bundle(), W.fl_of("plain")[1],
                               "client_parallel", 2, host_mesh)
    with pytest.raises(ValueError, match="client axes"):
        make_sharded_eval(lambda *a: a, host_mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        client_sharding(object())
