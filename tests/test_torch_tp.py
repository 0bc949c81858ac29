"""The tensor-parallel LM on the CPU: gloo process groups of 2 ranks (a
(1, 2) mesh: the model split in two) and 4 ranks (a (2, 2) mesh: two
data groups of two), against the port's one-device runs and JAX's round
function.

Each world size is one group of plain worker processes
(``tests/_torch_tp_worker.py``, one a rank, rendezvous through a file in
``tmp_path``) that runs every case in one session and writes its results
to npz files; the module fixture starts both groups together and runs
JAX's round function and the one-process engine launcher while they
work.  Cases: the launcher's round loop (FedAvg, FedFusion-conv and
FedMMD on reduced smollm-135m, head-parallel; FedAvg on reduced
gemma3-1b, whose projections are gathered), 2 rounds, compared by the
gathered state (a wrong backward collective shows only in the gradients)
and the losses; prefill and 6 teacher-forced decode steps over the
sequence-sharded cache (a slice that stays empty, gemma3-1b's ring
wrapping; batch 1 splits L over data and model); and ``launch.train
--engine`` at two ranks.  Tolerances:

* mesh vs one device: rtol 2e-5 / atol 1e-6 (the all-reduces sum in
  another order), for states and losses, and for logits divided by the
  one-device run's largest |logit| (near 200 at the random init, where
  one float32 ulp is 1.5e-5: the logits' own rounding is that large);
* the (1, 2) round vs JAX's ``build_train_step`` round function, jitted
  without shardings: rtol 1e-4 / atol 1e-5 (the port's parity tolerance;
  JAX's sharded LM jit does not run on jax 0.9.0);
* the engine launcher at two ranks vs one process: rtol 2e-5 / atol 1e-6
  on the final state, ``CommLog`` bytes equal;
* the gathered state is equal on every rank.
"""
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.base import InputShape as JShape
from repro.core import init_global_state as j_init_global_state
from repro.data.partition import source_partition as j_source_partition
from repro.data.synth import token_stream as j_token_stream
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.registry import make_bundle as j_make_bundle
from repro.optim import exp_decay_per_round as j_decay
from repro_torch.checkpoint.io import save_tree
from repro_torch.interop import state_from_numpy
from repro_torch.launch import train
from repro_torch.core.rounds import init_global_state
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_tp_worker.py")
WORKER_TIMEOUT_S = 240
RTOL, ATOL = 2e-5, 1e-6
J_RTOL, J_ATOL = 1e-4, 1e-5


class Group:
    def __init__(self, world, out, rcs, logs):
        self.world, self.out, self.rcs, self.logs = world, out, rcs, logs

    def load(self, job, rank=None):
        pat = os.path.join(self.out, "{}.r{}.npz".format(
            job.replace("/", "__"), "*" if rank is None else rank))
        found = sorted(glob.glob(pat))
        assert found, f"no result for {job!r} (rank {rank}): {self.logs}"
        with np.load(found[0]) as z:
            n = sum(k.startswith("leaf/") for k in z.files)
            return {"leaves": [z[f"leaf/{i}"] for i in range(n)],
                    "losses": z["losses"], "bytes": z["bytes"]}


def _jax_case():
    name, algorithm = W.TRAIN[W.JAX_CASE]
    return J_ARCHS[name].reduced(), dict(algorithm=algorithm,
                                         fusion_op="conv", local_steps=2,
                                         lr=0.05)


def _jax_state0(outs):
    """JAX's initial state for the worker's ``JAX_CASE``, also written
    (converted) into each of ``outs`` for the workers."""
    jcfg, fl_kw = _jax_case()
    s0 = j_init_global_state(j_make_bundle(jcfg), JFL(**fl_kw),
                             jax.random.PRNGKey(0))
    for out in outs:
        save_tree(str(out / "s0_jax.npz"),
                  state_from_numpy(jax.tree.map(np.asarray, s0)))
    return s0


def _jax_rounds(s0):
    """JAX's round function (jitted, no shardings) from ``s0`` on the
    launcher's batch draws and learning rates: (the final state's leaves
    in the port's order, the losses)."""
    jcfg, fl_kw = _jax_case()
    j_round = jax.jit(j_build_train_step(
        jcfg, JFL(**fl_kw), JShape("t", W.SHAPE.seq_len,
                                   W.SHAPE.global_batch, "train"),
        jax.make_mesh((1, 1), ("data", "model")), dtype=jnp.float32)[0])
    toks, src = j_token_stream(64, W.SHAPE.seq_len, vocab=jcfg.vocab_size,
                               n_sources=1)
    pool = j_source_partition(toks, src, 1)[0]["tokens"]
    rng = np.random.default_rng(0)
    lr_at = j_decay(0.05, 0.995)
    state, losses = s0, []
    for r in range(W.ROUNDS):
        arr = pool[rng.choice(len(pool), (2, W.SHAPE.global_batch))][None]
        batch = {"tokens": jnp.asarray(arr[..., :-1]),
                 "labels": jnp.asarray(arr[..., 1:])}
        state, metrics = j_round(state, batch, jnp.ones((1,)), lr_at(r))
        losses.append(float(metrics["local_loss"]))
    port = state_from_numpy(jax.tree.map(np.asarray, state))
    name, algorithm = W.TRAIN[W.JAX_CASE]
    like = init_global_state(make_bundle(W.cfg_of(name)), W.fl_of(algorithm),
                             torch.Generator().manual_seed(0), "cpu")
    # the port's key order (jax.tree.map sorts a dict's keys)
    port = tree_map(lambda _, x: x, like, port)
    return [t.numpy() for t in tree_leaves(port)], losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write JAX's initial state, start both worker groups, run JAX's
    round function and the one-process engine launcher while they work,
    then collect the groups."""
    root = tmp_path_factory.mktemp("tp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    outs = {w: root / f"w{w}" for w in W.MESHES}
    for out in outs.values():
        out.mkdir()
    s0 = _jax_state0(outs.values())      # before the workers: they read it
    procs = {}
    for world, out in outs.items():
        init = root / f"init{world}"
        procs[world] = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(init),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    jax_ref = _jax_rounds(s0)
    one = train.main(W.ENGINE_ARGS)
    engine_single = {"leaves": [t.detach().numpy() for t in
                                tree_leaves(one.global_state)],
                     "bytes": [one.comm.bytes_up, one.comm.bytes_down]}
    groups = {}
    for world, ps in procs.items():
        logs, rcs = [], []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
            rcs.append(p.returncode)
        groups[world] = Group(world, str(outs[world]), rcs,
                              [log[-3000:] for log in logs])
    return {"groups": groups, "jax": jax_ref, "engine": engine_single}


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", sorted(W.MESHES))
def test_worker_groups_finish(run, world):
    g = run["groups"][world]
    assert g.rcs == [0] * world, g.logs


@pytest.mark.parametrize("case", sorted(W.TRAIN))
@pytest.mark.parametrize("world", sorted(W.MESHES))
def test_tp_round_matches_one_device(run, world, case):
    """The launcher's rounds on the mesh (gathered state, losses) against
    the same rounds on one device with the mesh's plan; the gathered
    state is the same on every rank."""
    g = run["groups"][world]
    got = g.load(f"train/{case}", 0)
    want = g.load(f"train/{case}/single")
    _close(got["leaves"], want["leaves"], RTOL, ATOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(got["losses"]).all()
    for r in range(1, world):
        other = g.load(f"train/{case}", r)
        for a, b in zip(got["leaves"], other["leaves"]):
            np.testing.assert_array_equal(a, b)


def test_tp_round_matches_jax_round_fn(run):
    """The (1, 2) mesh's FedFusion-conv rounds from JAX's initial state
    against JAX's round function on the same draws."""
    got = run["groups"][2].load(f"train/{W.JAX_CASE}", 0)
    leaves, losses = run["jax"]
    _close(got["leaves"], leaves, J_RTOL, J_ATOL)
    np.testing.assert_allclose(got["losses"], losses, rtol=J_RTOL,
                               atol=J_ATOL)


@pytest.mark.parametrize("world,case", [(w, c) for w in sorted(W.SERVE)
                                        for c in sorted(W.SERVE[w])])
def test_tp_prefill_and_decode_match_one_device(run, world, case):
    """Prefill's last logits and 6 teacher-forced decode steps' logits
    over the sequence-sharded cache against one device."""
    g = run["groups"][world]
    got = g.load(f"serve/{case}", 0)["leaves"][0]
    want = g.load(f"serve/{case}/single")["leaves"][0]
    assert got.shape == want.shape == (W.SERVE[world][case][1], W.STEPS + 1,
                                       512)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL)


def test_engine_launcher_at_two_ranks_matches_one_process(run):
    """``launch.train.main(["--engine", ...])`` with WORLD_SIZE / RANK set
    goes through its engine mesh (two client shards) and ends where the
    one-process run does, with the same bytes."""
    g = run["groups"][2]
    one = run["engine"]
    for r in range(2):
        got = g.load("engine", r)
        _close(got["leaves"], one["leaves"], RTOL, ATOL)
        assert list(got["bytes"]) == one["bytes"]
