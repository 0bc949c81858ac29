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
