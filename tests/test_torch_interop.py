"""Weight conversion between the packages, and the port's import and device
hygiene: it loads no JAX and no module of ``repro``, and its entry points
refuse to fall back to the CPU silently."""
import ast
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_CIFAR as J_CIFAR
from repro.core import init_global_state as j_init_global_state
from repro.models import transformer as j_tfm
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import CNN_CIFAR, FLConfig, get_config
from repro_torch.core import init_global_state
from repro_torch.data import FederatedDataset, class_images, iid_partition
from repro_torch.fl.server import run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.launch import serve
from repro_torch.models import make_bundle
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves

SRC = os.path.dirname(os.path.dirname(repro_torch.__file__))


@pytest.mark.parametrize("algorithm,op", [("fedavg", "multi"),
                                          ("fedfusion", "conv"),
                                          ("fedfusion", "single")])
def test_state_round_trips(algorithm, op):
    fl = JFL(algorithm=algorithm, fusion_op=op)
    state = jax.tree.map(np.asarray, j_init_global_state(
        j_make_bundle(J_CIFAR), fl, jax.random.PRNGKey(0)))
    port = state_from_numpy(state)
    assert set(port) == set(state)
    w = port["model"]["convs"][1]["w"]
    assert tuple(w.shape) == (64, 64, 5, 5)            # OIHW
    np.testing.assert_array_equal(
        w[3, 7].numpy(), state["model"]["convs"][1]["w"][:, :, 7, 3])
    back = state_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["params", "cache"])
def test_transformer_trees_round_trip(which):
    """gemma3-1b reduced: a 2-kind cycle (local, global); the JAX tree
    crosses exactly, tuples stay tuples, and its structure, shapes and
    dtypes are those of the port's own init_params / init_cache."""
    jcfg = J_ARCHS["gemma3-1b"].reduced()
    cfg = get_config("gemma3-1b").reduced()
    if which == "params":
        jtree = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
        own = tfm.init_params(cfg, torch.Generator(), device="cpu")
    else:
        jtree = j_tfm.init_cache(jcfg, 2, 70)
        own = tfm.init_cache(cfg, 2, 70, device="cpu")
    jtree = jax.tree.map(np.asarray, jtree)
    port = state_from_numpy(jtree)
    assert isinstance(port["cycles"], tuple) and len(port["cycles"]) == 2
    assert jax.tree.structure(port) == jax.tree.structure(own)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = state_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_native_state_round_trips():
    bundle = make_bundle(CNN_CIFAR)
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv")
    state = init_global_state(bundle, fl, torch.Generator().manual_seed(0),
                              device="cpu")
    again = state_from_numpy(state_to_numpy(state))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(again)):
        assert torch.equal(a, b)
    assert tuple(state["fusion"]["w"].shape) == (128, 64)


def test_package_imports_no_jax_and_no_repro():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.mk_mmd" in modules
    assert {"repro_torch.launch.serve", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attn",
            "repro_torch.kernels.decode_attn"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _script_imports(name):
    """The modules a script at the root of the repository imports."""
    path = os.path.join(os.path.dirname(SRC), name)
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax_and_no_repro():
    names = _script_imports("chip_smoke.py")
    assert "repro_torch.fl.server" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                        "repro")]


def test_kernel_ab_imports_no_jax_and_no_repro():
    names = _script_imports("kernel_ab.py")
    assert {"chip_smoke", "repro_torch.kernels"} <= names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                        "repro")]


def test_entry_points_refuse_a_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    bundle = make_bundle(CNN_CIFAR)
    fl = FLConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_global_state(bundle, fl, torch.Generator())
    x, y = class_images(2, shape=(32, 32, 3))
    data = FederatedDataset(iid_partition(x, y, 2), {"x": x, "y": y})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated_reference(bundle, FLConfig(clients_per_round=2), data,
                                rounds=1)
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_prompts(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "smollm-135m"])


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "newclient_generalization_torch.py",
                                  "train_lm_federated_torch.py",
                                  "serve_decode_torch.py"])
def test_example_twins_import_no_jax_and_no_repro(name):
    names = _script_imports(os.path.join("examples", name))
    assert "repro_torch.models" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                        "repro")]


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "newclient_generalization_torch.py"])
def test_example_twins_refuse_a_silent_cpu_fallback(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    import importlib.util
    path = os.path.join(os.path.dirname(SRC), "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(1, verbose=False, n_per_class=2, n_test_per_class=1,
                 n_clients=2, clients_per_round=2)


# --------------------------------------------------------------------------
# resuming the port from a checkpoint the JAX package wrote
# --------------------------------------------------------------------------

def _fusion_topk_setup():
    import dataclasses

    from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
    from repro.data.federated import FederatedDataset as JFD
    from repro_torch.configs import CNN_MNIST
    from test_torch_rounds import NARROW, _data
    fl_kw = dict(algorithm="fedfusion", fusion_op="conv",
                 clients_per_round=2, local_steps=2, local_batch=8, lr=0.05,
                 uplink_codec="topk", topk_frac=1 / 16)
    parts, test = _data(NARROW["input_shape"], 4, 40)
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **NARROW))
    tb = make_bundle(dataclasses.replace(CNN_MNIST, **NARROW))
    return (fl_kw, jb, tb, lambda: JFD(parts, test, seed=0),
            lambda: FederatedDataset(parts, test, seed=0))


def test_resume_from_a_jax_checkpoint_equals_jax_uninterrupted(tmp_path):
    """JAX's ``run_federated`` (top-k uplink, FedFusion-conv) writes a
    checkpoint at round 2; the port converts it and resumes to 4, then
    (its own layout now, marked in meta.json) to 5.  Models, the EF table,
    the mirror and the resumed rounds' history equal JAX's uninterrupted
    5-round run (rtol 1e-4 / atol 1e-5, bytes exactly)."""
    import json

    from repro.fl.server import run_federated as j_run_federated
    from repro_torch.checkpoint.convert import load_jax_ef
    from repro_torch.fl.server import run_federated
    fl_kw, jb, tb, jdata, tdata = _fusion_topk_setup()
    kw = dict(seed=1, eval_examples=64, superstep_rounds=2)
    full = j_run_federated(jb, JFL(**fl_kw), jdata(), rounds=5,
                           checkpoint_dir=str(tmp_path / "full"),
                           checkpoint_every=5, **kw)
    ckpt = str(tmp_path / "ckpt")
    j_run_federated(jb, JFL(**fl_kw), jdata(), rounds=2,
                    checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    assert "layout" not in json.load(open(os.path.join(ckpt, "meta.json")))
    first = run_federated(tb, FLConfig(**fl_kw), tdata(), rounds=4,
                          checkpoint_dir=ckpt, checkpoint_every=2,
                          checkpoint_from_jax=True, device="cpu", **kw)
    assert json.load(open(os.path.join(ckpt, "meta.json"))) == {
        "round": 4, "algorithm": "fedfusion", "layout": "repro_torch"}
    second = run_federated(tb, FLConfig(**fl_kw), tdata(), rounds=5,
                           checkpoint_dir=ckpt, checkpoint_every=2,
                           checkpoint_from_jax=True, device="cpu", **kw)
    resumed = first.comm.history + second.comm.history
    assert [h["round"] for h in resumed] == [1, 2, 1]
    for got, want in zip(resumed, full.comm.history[2:]):
        for k in ("bytes_up", "bytes_down", "bytes_up_ideal"):
            assert got[k] == want[k]
        for k in ("local_loss", "loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5)
    got = state_to_numpy(second.global_state)
    want = jax.tree.map(np.asarray, full.global_state)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    # the EF table and the mirror: JAX's final ef.npz converted against
    # the port's own final ef.npz
    from repro_torch.checkpoint.io import load_tree
    model = second.global_state["model"]
    ef_like = [torch.empty((4, t.numel()), device="meta")
               for t in tree_leaves(model)]
    want_ef, want_mirror = load_jax_ef(
        str(tmp_path / "full" / "ef.npz"), ef_like, model, "cpu")
    got_ef, got_mirror = load_tree(os.path.join(ckpt, "ef.npz"),
                                   (ef_like, model), "cpu")
    for g, w in zip(got_ef + tree_leaves(got_mirror),
                    want_ef + tree_leaves(want_mirror)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert any(float(e.abs().max()) > 0 for e in got_ef)


def test_a_port_checkpoint_resumes_as_the_port_s_with_the_flag(tmp_path):
    """Every save of the port marks its directory, so a directory the port
    wrote without ``checkpoint_from_jax`` is still read in the port's
    layout when a later run passes the flag: the resumed run equals the
    one resumed without it, exactly."""
    from repro_torch.checkpoint.convert import jax_layout
    from repro_torch.fl.server import run_federated
    fl_kw, _, tb, _, tdata = _fusion_topk_setup()
    kw = dict(seed=1, eval_examples=64, superstep_rounds=1, device="cpu")
    out = {}
    for flag in (False, True):
        ckpt = str(tmp_path / f"ckpt{flag}")
        run_federated(tb, FLConfig(**fl_kw), tdata(), rounds=1,
                      checkpoint_dir=ckpt, **kw)
        assert not jax_layout(ckpt, True)
        out[flag] = run_federated(tb, FLConfig(**fl_kw), tdata(), rounds=2,
                                  checkpoint_dir=ckpt,
                                  checkpoint_from_jax=flag, **kw)
    assert out[True].comm.history == out[False].comm.history
    for a, b in zip(tree_leaves(out[True].global_state),
                    tree_leaves(out[False].global_state)):
        assert torch.equal(a, b)


def test_jax_checkpoint_layout_needs_the_flag_and_scratch_rows_refused(
        tmp_path):
    """Without ``checkpoint_from_jax`` a directory is read in the port's
    layout (the JAX one then fails on the conv weights' shape); with it
    the reference loop resumes too; an EF table whose rows are not the
    federation's (six rows for the four clients here, as a table with
    scratch rows would have) is refused, naming the row counts."""
    from repro.fl.server import run_federated as j_run_federated
    from repro_torch.checkpoint.convert import jax_layout, load_jax_ef
    from repro_torch.fl.server import run_federated
    fl_kw, jb, tb, jdata, tdata = _fusion_topk_setup()
    ckpt = str(tmp_path / "ckpt")
    j_run_federated(jb, JFL(**fl_kw), jdata(), rounds=1, seed=1,
                    eval_examples=64, checkpoint_dir=ckpt)
    assert jax_layout(ckpt, True) and not jax_layout(ckpt, False)
    with pytest.raises(RuntimeError):
        run_federated(tb, FLConfig(**fl_kw), tdata(), rounds=2, seed=1,
                      eval_examples=64, checkpoint_dir=ckpt, device="cpu")
    # the reference loop converts it too, and marks the directory
    import json
    res = run_federated_reference(tb, FLConfig(**fl_kw), tdata(), rounds=2,
                                  seed=1, eval_examples=64,
                                  checkpoint_dir=ckpt,
                                  checkpoint_from_jax=True, device="cpu")
    assert res.comm.rounds == 1
    assert all(np.isfinite(h["local_loss"]) for h in res.comm.history)
    assert json.load(open(os.path.join(ckpt, "meta.json")))["layout"] == \
        "repro_torch"
    model = state_from_numpy(jax.tree.map(np.asarray, j_init_global_state(
        jb, JFL(**fl_kw), jax.random.PRNGKey(0))))["model"]
    like = [torch.empty((6, t.numel()), device="meta")
            for t in tree_leaves(model)]
    with pytest.raises(ValueError, match="not the federation's"):
        load_jax_ef(os.path.join(ckpt, "ef.npz"), like, model)
