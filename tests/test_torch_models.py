"""The port's paper CNNs against the JAX package's at full published width,
from the same (converted) JAX parameters: feature maps, logits and pooled
features, through the model functions and through the ModelBundle.

Tolerance: XLA's and oneDNN's float32 convolutions sum their 5x5xC_in
products in different orders; over two conv layers and the FC stack the
outputs agree to ~1e-6 of their scale, held here at rtol 1e-5 with an
atol of 1e-5 of each output's scale.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.cnn_paper import CNN_CIFAR as J_CIFAR
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.models import cnn as jcnn
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import CNN_CONFIGS
from repro_torch.configs.base import FLConfig
from repro_torch.interop import state_from_numpy
from repro_torch.models import cnn as tcnn
from repro_torch.models.registry import make_bundle


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("jcfg", [J_MNIST, J_CIFAR], ids=lambda c: c.name)
def test_cnn_matches_jax_at_full_width(jcfg):
    tcfg = CNN_CONFIGS[jcfg.name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.feature_hw == jcfg.feature_hw
    params = jax.tree.map(np.asarray,
                          jcnn.cnn_init(jcfg, jax.random.PRNGKey(3)))
    x = np.random.default_rng(0).standard_normal(
        (4,) + jcfg.input_shape).astype(np.float32)
    jout = jcnn.cnn_apply(jcfg, params, x)
    tparams = state_from_numpy(params)
    tout = tcnn.cnn_apply(tcfg, tparams, torch.from_numpy(x))
    assert tuple(tout["features"].shape) == jout["features"].shape
    _close(tout["features"], jout["features"])
    _close(tout["logits"], jout["logits"])
    # the head alone, on the JAX features (NHWC flatten order)
    _close(tcnn.cnn_head(tcfg, tparams, torch.from_numpy(
        np.array(jout["features"]))), jout["logits"])


@pytest.mark.parametrize("name", ["cnn_mnist", "cnn_cifar"])
def test_bundle_matches_jax(name):
    tcfg = CNN_CONFIGS[name]
    jb = j_make_bundle({"cnn_mnist": J_MNIST, "cnn_cifar": J_CIFAR}[name])
    tb = make_bundle(tcfg)
    assert (tb.name, tb.loss_kind, tb.feature_channels) == \
        (jb.name, jb.loss_kind, jb.feature_channels)
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {"x": rng.standard_normal((3,) + tcfg.input_shape).astype(
        np.float32), "y": np.array([1, 2, 3], np.int32)}
    jf, _ = jb.extract(params, batch)
    tf, aux = tb.extract(state_from_numpy(params),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux == 0.0
    _close(tf, jf)
    _close(tb.pool(tf), jb.pool(jf))
    _close(tb.head(state_from_numpy(params), tf), jb.head(params, jf))
    assert np.array_equal(tb.labels(batch), jb.labels(batch))


def test_port_init_shapes_and_distribution():
    """Port-native init: the JAX package's shapes (conv w OIHW), the same
    truncated-normal fan-in distribution, different numbers."""
    cfg = CNN_CONFIGS["cnn_mnist"]
    params = make_bundle(cfg).init(torch.Generator().manual_seed(0))
    jparams = jcnn.cnn_init(J_MNIST, jax.random.PRNGKey(0))
    for t, j in zip(jax.tree.leaves(params), jax.tree.leaves(
            state_from_numpy(jax.tree.map(np.asarray, jparams)))):
        assert t.shape == j.shape and t.dtype == j.dtype
    w = params["fcs"][0]["w"]
    scale = 1.0 / np.sqrt(w.shape[0])
    assert w.abs().max() <= 2.0 * scale + 1e-7
    assert abs(w.std().item() / scale - 0.88) < 0.02  # std of N(0,1) on ±2
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert 1_600_000 < n < 1_700_000     # ≈1.66 M params


def test_make_bundle_refuses_other_configs():
    with pytest.raises(NotImplementedError):
        make_bundle(FLConfig())
