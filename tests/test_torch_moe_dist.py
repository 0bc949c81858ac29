"""The port's MoE family over two gloo ranks on the CPU, against the JAX
package and against one device (``tests/_torch_moe_worker.py``, one plain
process a rank, rendezvous through a file in ``tmp_path``; the module
fixture starts them, then computes JAX's side while they work):

* ``moe_dispatch.moe_apply_a2a`` on a (2, 1) mesh (each rank its batch
  block and 4 of the 8 experts), at a capacity that drops nothing, and
  the gradients of sum(out * g), against JAX's ``moe_reference`` and
  ``jax.grad`` of it (the router's gradient summed over the ranks: each
  rank's holds its own tokens' share);
* the same at a tight capacity (tokens dropped per source rank) against
  JAX's ``moe_apply_a2a`` on two forced host devices in a subprocess, as
  ``tests/test_moe_dispatch.py`` runs it;
* reduced granite-moe-1b and arctic-480b split over ``model`` on a (1, 2)
  mesh: one ``launch.train`` FedAvg round and a serving run (prefill and
  6 teacher-forced decode steps) against one device;
* a decode-graph capture on the gloo mesh is refused, and
  ``launch.serve`` there prints ``decode: eager (gloo)`` first.

Tolerances: against JAX rtol 1e-4 with an atol of 1e-4 of each output's
scale (the port's parity tolerance); serving on the mesh against one
device rtol 2e-5 / atol 1e-6 (the all-reduces sum in another order),
logits divided by the one-device run's largest |logit|, as
``tests/test_torch_tp.py``.  The rounds on the mesh against one device:
rtol 1e-4 / atol 1e-5, the port's parity tolerance for parameters.  A
round moves the router by ~0.2 and float32 rounds that update to ~4.5e-6
on one device alone (against the same round in float64), above the dense
models' 1e-6.
"""
import glob
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_moe_worker as W
from repro.models import moe as jmoe

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_moe_worker.py")
TIMEOUT_S = 240
WORLD = 2
RTOL, ATOL = 2e-5, 1e-6
J_RTOL, J_ATOL = 1e-4, 1e-5
D, F_, E = 16, 32, 8

JAX_A2A = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.models.moe_dispatch import moe_apply_a2a
    z = np.load(sys.argv[1])
    params = {k: jnp.asarray(z[k]) for k in ("router", "w1", "w2", "w3")}
    mesh = make_mesh((2,), ("data",))
    with mesh_context(mesh):
        out, aux = jax.jit(lambda p, x: moe_apply_a2a(
            p, x, mesh, top_k=%d, act=%r, capacity_factor=%r))(
                params, jnp.asarray(z["x"]))
    np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux))
""") % (W.TOP_K, W.ACT, W.A2A["a2a/tight"])


def _inputs():
    """JAX's ``moe_init`` leaves, x [4, 6, d] ~ N(1, 1) (the offset skews
    the routing) and g [4, 6, d] ~ N(0, 1)."""
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), D, E,
                                               F_, W.ACT))
    rng = np.random.default_rng(1)
    x = (1.0 + rng.standard_normal((4, 6, D))).astype(np.float32)
    g = rng.standard_normal((4, 6, D)).astype(np.float32)
    return dict(p, x=x, g=g)


def _jax_reference(a):
    """moe_reference's output and jax.grad of sum(out * g) by x and the
    leaves."""
    params = {k: jnp.asarray(a[k]) for k in ("router", "w1", "w2", "w3")}

    def loss(p, x):
        out = jmoe.moe_reference(p, x, top_k=W.TOP_K, act=W.ACT)
        return jnp.sum(out * a["g"]), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        params, jnp.asarray(a["x"]))
    return {"out": np.asarray(out), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for k in ("WORLD_SIZE", "RANK", "XLA_FLAGS"):
        env.pop(k, None)
    a = _inputs()
    np.savez(root / "a2a_in.npz", **a)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(root / "init"),
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    jax_a2a = subprocess.Popen(
        [sys.executable, "-c", JAX_A2A, str(root / "a2a_in.npz"),
         str(root / "jax_a2a.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    ref = _jax_reference(a)
    logs, rcs = [], []
    for p in procs + [jax_a2a]:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0][-3000:])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0][-3000:])
        rcs.append(p.returncode)
    return {"root": str(root), "rcs": rcs, "logs": logs, "inputs": a,
            "ref": ref}


def _load(run, job, rank=None):
    pat = os.path.join(run["root"], "{}.r{}.npz".format(
        job.replace("/", "__"), "*" if rank is None else rank))
    found = sorted(glob.glob(pat))
    assert found, f"no result for {job!r}: {run['logs']}"
    with np.load(found[0]) as z:
        return [z[f"leaf/{i}"] for i in range(len(z.files))]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_workers_and_the_jax_subprocess_finish(run):
    assert run["rcs"] == [0] * (WORLD + 1), run["logs"]


def test_a2a_and_its_gradient_match_the_jax_reference(run):
    ranks = [_load(run, "a2a/full", r) for r in range(WORLD)]
    ref = run["ref"]
    _close(np.concatenate([r[0] for r in ranks]), ref["out"])
    _close(np.concatenate([r[2] for r in ranks]), ref["x"])
    _close(sum(r[3] for r in ranks), ref["router"])
    for i, k in enumerate(("w1", "w2", "w3")):
        _close(np.concatenate([r[4 + i] for r in ranks]), ref[k])
    assert ranks[0][1] == ranks[1][1] and np.isfinite(ranks[0][1])


def test_a2a_at_a_tight_capacity_matches_jax_a2a(run):
    ranks = [_load(run, "a2a/tight", r) for r in range(WORLD)]
    with np.load(os.path.join(run["root"], "jax_a2a.npz")) as z:
        want_out, want_aux = z["out"], z["aux"]
    out = np.concatenate([r[0] for r in ranks])
    _close(out, want_out)
    for r in ranks:
        np.testing.assert_allclose(r[1], want_aux, rtol=1e-4, atol=1e-5)
    # tokens were dropped: not the dense mix
    assert np.abs(out - run["ref"]["out"]).max() > 1e-3


@pytest.mark.parametrize("case", sorted(W.TRAIN))
def test_moe_round_split_over_model_matches_one_device(run, case):
    got = _load(run, f"train/{case}", 0)
    want = _load(run, f"train/{case}/single")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=J_RTOL, atol=J_ATOL)
    assert np.isfinite(got[-1]).all()
    for a, b in zip(got, _load(run, f"train/{case}", 1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(W.SERVE))
def test_moe_serving_split_over_model_matches_one_device(run, case):
    got = _load(run, f"serve/{case}", 0)[0]
    want = _load(run, f"serve/{case}/single")[0]
    assert got.shape == want.shape == (4, 7, 512)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL)


def test_decode_graph_capture_is_refused_on_a_gloo_mesh(run):
    for r in range(WORLD):
        assert list(_load(run, "gloo_capture", r)[0]) == [1, 1]
