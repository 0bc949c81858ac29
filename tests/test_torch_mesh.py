"""The mesh half of the model families on the CPU: gloo process groups of
2 ranks (a (1, 2) mesh, the model split; a (2, 1) mesh, the FSDP round)
and 4 ranks (a (2, 2) mesh: both, the production layout of qwen2-vl-7b
and recurrentgemma-9b), against the port's one-device runs and JAX's
round function.

Each world size is one group of plain worker processes
(``tests/_torch_mesh_worker.py``, one a rank, rendezvous through a file
in ``tmp_path``) that runs every case in one go and writes its
results to npz files; the module fixture starts both groups together and
runs JAX's round function while they work.  Cases, at the ``reduced()``
size of each family: every architecture's train, prefill and decode
steps built on each mesh; the launcher's round loop, one round of
FedAvg, FedFusion-conv, FedMMD or FedL2, on mamba2-130m (SSD),
recurrentgemma-9b (RG-LRU and local attention), whisper-large-v3 (the
encoder, cross-attention), qwen2-vl-7b (M-RoPE, ``vis_proj``),
arctic-480b (MoE with a dense residual, experts split over ``data``;
also with the all-to-all dispatch, which leaves them split, at a
capacity that drops no token, against the gather dispatch on one device)
and smollm-135m set to ``client_sequential`` (the dense model under
FSDP, also at one row a client, which every data rank computes),
compared by the gathered state (a wrong backward collective shows only
in the gradients) and the losses; prefill and 4 teacher-forced decode
steps of the four new families, the cross cache split over ``model``
(and over ``data`` at batch 1), compared by the logits.  Tolerances, set
before the first run:

* mesh vs one device: rtol 2e-5 / atol 1e-6 (the all-reduces sum in
  another order), for states and losses, and for logits divided by the
  one-device run's largest |logit|, as ``tests/test_torch_tp.py``;
  arctic-480b's rounds rtol 1e-4 / atol 1e-5, as
  ``tests/test_torch_moe_dist.py`` (float32 rounds a router update to
  ~4.5e-6 on one device alone);
* the (2, 2) FedMMD round of qwen2-vl-7b from JAX's initial state vs
  JAX's ``build_train_step`` round function, jitted without shardings:
  rtol 1e-4 / atol 1e-5 (JAX's sharded LM jit does not run on jax 0.9.0);
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

import _torch_mesh_worker as W
from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.base import InputShape as JShape
from repro.core import init_global_state as j_init_global_state
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.registry import make_bundle as j_make_bundle
from repro.optim import exp_decay_per_round as j_decay
from repro_torch.checkpoint.io import save_tree
from repro_torch.configs import ARCH_CONFIGS, InputShape
from repro_torch.core.rounds import init_global_state
from repro_torch.interop import state_from_numpy
from repro_torch.launch import train
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import fl_plan
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")
WORKER_TIMEOUT_S = 240
RTOL, ATOL = 2e-5, 1e-6
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
J_RTOL, J_ATOL = 1e-4, 1e-5
WORLDS = {shape: world for world, shapes in W.MESHES.items()
          for shape in shapes}


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
                    "losses": z["losses"]}


def _jax_case():
    shape, case = W.JAX_CASE
    family, algorithm, B = W.TRAIN[shape][case]
    jcfg = J_ARCHS[W.ARCH[family]].reduced()
    return jcfg, dict(algorithm=algorithm, fusion_op="conv", local_steps=2,
                      lr=0.05), B


def _jax_state0(out):
    """JAX's initial state for the worker's ``JAX_CASE``, also written
    (converted) into ``out`` for the workers."""
    jcfg, fl_kw, _ = _jax_case()
    s0 = j_init_global_state(j_make_bundle(jcfg), JFL(**fl_kw),
                             jax.random.PRNGKey(0))
    save_tree(str(out / "s0_jax.npz"),
              state_from_numpy(jax.tree.map(np.asarray, s0)))
    return s0


def _jax_rounds(s0):
    """JAX's round function (jitted, no shardings) from ``s0`` on the
    launcher's batch draws (its tokens and stub patch embeddings) and
    learning rates: (the final state's leaves in the port's order, the
    losses)."""
    jcfg, fl_kw, B = _jax_case()
    shape, case = W.JAX_CASE
    family = W.TRAIN[shape][case][0]
    cfg = W.cfg_of(family)
    j_round = jax.jit(j_build_train_step(
        jcfg, JFL(**fl_kw), JShape("t", W.SEQ, B, "train"),
        jax.make_mesh((1, 1), ("data", "model")), dtype=jnp.float32)[0])
    tshape = InputShape("t", W.SEQ, B, "train")
    plan = fl_plan(cfg, tshape, MeshSpec(shape, W.AXES))
    draw = train.round_batches(cfg, tshape, plan)
    lr_at = j_decay(0.05, 0.995)
    state, losses = s0, []
    for r in range(W.ROUNDS):
        batch = {k: jnp.asarray(v.numpy()) for k, v in draw().items()}
        state, metrics = j_round(state, batch, jnp.ones((plan.n_clients,)),
                                 lr_at(r))
        losses.append(float(metrics["local_loss"]))
    port = state_from_numpy(jax.tree.map(np.asarray, state))
    like = init_global_state(make_bundle(cfg), W.fl_of(fl_kw["algorithm"]),
                             torch.Generator().manual_seed(0), "cpu")
    # the port's key order (jax.tree.map sorts a dict's keys)
    port = tree_map(lambda _, x: x, like, port)
    return [t.numpy() for t in tree_leaves(port)], losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write JAX's initial state, start both worker groups, run JAX's
    round function while they work, then collect the groups."""
    root = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    outs = {w: root / f"w{w}" for w in W.MESHES}
    for out in outs.values():
        out.mkdir()
    s0 = _jax_state0(outs[WORLDS[W.JAX_CASE[0]]])  # before the workers
    procs = {}
    for world, out in outs.items():
        init = root / f"init{world}"
        procs[world] = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(init),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    jax_ref = _jax_rounds(s0)
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
    return {"groups": groups, "jax": jax_ref}


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", sorted(W.MESHES))
def test_worker_groups_finish(run, world):
    g = run["groups"][world]
    assert g.rcs == [0] * world, g.logs


@pytest.mark.parametrize("shape", sorted(WORLDS), ids=W.tag)
def test_every_architecture_builds_its_steps_on_the_mesh(run, shape):
    """Each JAX architecture's train, prefill and decode steps build on
    the mesh, the train step's layouts ``param_shardings(..., fsdp=)`` of
    its mode (FSDP for the client-sequential ones)."""
    got = run["groups"][WORLDS[shape]].load(f"build/{W.tag(shape)}", 0)
    assert list(got["leaves"][0]) == [1] * len(ARCH_CONFIGS)


@pytest.mark.parametrize("shape,case", [(s, c) for s in sorted(W.TRAIN)
                                        for c in sorted(W.TRAIN[s])],
                         ids=lambda v: W.tag(v) if isinstance(v, tuple)
                         else v)
def test_mesh_round_matches_one_device(run, shape, case):
    """The launcher's round on the mesh (gathered state, losses) against
    the same round on one device with the mesh's plan; the gathered state
    is the same on every rank."""
    g = run["groups"][WORLDS[shape]]
    job = f"train/{W.tag(shape)}/{case}"
    got, want = g.load(job, 0), g.load(job + "/single")
    family = W.TRAIN[shape][case][0]
    rtol, atol = ((MOE_RTOL, MOE_ATOL) if family.startswith("arctic")
                  else (RTOL, ATOL))
    _close(got["leaves"], want["leaves"], rtol, atol)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol,
                               atol=atol)
    assert np.isfinite(got["losses"]).all()
    for r in range(1, g.world):
        other = g.load(job, r)
        for a, b in zip(got["leaves"], other["leaves"]):
            np.testing.assert_array_equal(a, b)


def test_fsdp_round_matches_jax_round_fn(run):
    """The (2, 2) mesh's FedMMD round of qwen2-vl-7b (FSDP: leaves split
    over data, the model over model) from JAX's initial state against
    JAX's round function on the same draws."""
    shape, case = W.JAX_CASE
    got = run["groups"][WORLDS[shape]].load(f"train/{W.tag(shape)}/{case}",
                                            0)
    leaves, losses = run["jax"]
    _close(got["leaves"], leaves, J_RTOL, J_ATOL)
    np.testing.assert_allclose(got["losses"], losses, rtol=J_RTOL,
                               atol=J_ATOL)


@pytest.mark.parametrize("shape,case", [(s, c) for s in sorted(W.SERVE)
                                        for c in sorted(W.SERVE[s])],
                         ids=lambda v: W.tag(v) if isinstance(v, tuple)
                         else v)
def test_mesh_prefill_and_decode_match_one_device(run, shape, case):
    """Prefill's last logits and 4 teacher-forced decode steps' logits on
    the mesh (the caches the ranks' blocks: SSD / RG-LRU states and conv
    windows, the cross cache split on its frames) against one device."""
    g = run["groups"][WORLDS[shape]]
    job = f"serve/{W.tag(shape)}/{case}"
    got = g.load(job, 0)["leaves"][0]
    want = g.load(job + "/single")["leaves"][0]
    family, B = W.SERVE[shape][case]
    assert got.shape == want.shape == (B, W.STEPS + 1,
                                       W.cfg_of(family).vocab_size)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL)
