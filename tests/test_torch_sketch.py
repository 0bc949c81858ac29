"""The sketch codecs ``mask`` and ``lowrank`` (``repro_torch.compress.sketch``)
against the JAX package's ``SketchCodec`` on the CPU.

The port cannot redraw ``jax.random``: it expands each leaf's operator from
its seed with its own counter-based hash.  So the wire format is held to
JAX's with JAX's draws handed to ``SketchCodec._expand`` (payload values
and bytes equal, decode within 1e-6), and the port's own expansion is held
to what the estimator needs: a mask of k distinct ascending indices, and
an unbiased decode (mean over 2,000 seeds within 3 standard errors of x).
Bytes per round equal JAX's on the reference loop, and the engine equals
the port's reference loop exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rounds import BYTE_KEYS, NARROW, _data

import repro.compress as jcomp
from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.fl.server import run_federated_reference as j_ref
from repro.models.registry import make_bundle as j_make_bundle
import repro_torch.compress as tcomp
from repro_torch.checkpoint.convert import _jax_leaf_paths
from repro_torch.checkpoint.io import _paths
from repro_torch.compress.sketch import SketchCodec, hash_keys
from repro_torch.configs import CNN_MNIST as T_MNIST
from repro_torch.configs import FLConfig as TFL
from repro_torch.data import FederatedDataset as TFD
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

FRAC = 1 / 16


@functools.cache
def _model():
    """A narrow CNN_MNIST's parameters as numpy (JAX layout) and as the
    port's tensors: 4-D conv weights, matrices and vectors."""
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **NARROW))
    s0 = j_init_global_state(jb, JFL(), jax.random.PRNGKey(0))
    model = jax.tree.map(np.asarray, s0["model"])
    return model, state_from_numpy(model)


class JaxDraws(SketchCodec):
    """The port's codec expanding JAX's operator for each seed."""

    def _expand(self, seed, i):
        key = jax.random.PRNGKey(jnp.uint32(int(seed.reshape(-1)[0])))
        if self._is_matrix(i):
            cols, r = self._wire_shape(i)[-1], self._rank(i)
            g = jax.random.normal(key, (cols, r), jnp.float32) * (r ** -0.5)
            return torch.from_numpy(np.array(g))
        idx = jax.random.choice(key, self._n(i), (self._k(i),),
                                replace=False)
        return torch.from_numpy(np.array(idx)).long()


@pytest.mark.parametrize("mode", ["mask", "lowrank"])
def test_wire_format_equals_jax_with_jax_draws(mode):
    jmodel, tmodel = _model()
    jc = jcomp.make_codec(mode, topk_frac=FRAC).bind(jmodel)
    tc = JaxDraws(FRAC, mode=mode).bind(tmodel)
    delta_np = jax.tree.map(
        lambda a: np.random.default_rng(a.size).standard_normal(
            a.shape).astype(np.float32), jmodel)
    jp, _ = jc.encode(jax.tree.map(jnp.asarray, delta_np))
    # without a key JAX's leaf j (in its sorted leaf order) takes seed
    # j + 1; the port's leaf with the same path gets that seed through its
    # offset, u = (j + 1) / 2**31
    order = [p for p, _ in _jax_leaf_paths(tmodel)]
    to_jax = [order.index(p) for p, _ in _paths(tmodel)]
    tp, _ = tc.encode(state_from_numpy(delta_np),
                      noise=[torch.tensor([(j + 1) * 2.0 ** -31])
                             for j in to_jax])
    assert tc.wire_bytes() == jc.wire_bytes() == jc.nbytes(jp) == \
        tc.nbytes(tp)
    jleaves = {int(np.asarray(p["seed"])[0]): p for p in jp}
    n_matrix = 0
    for i, p in enumerate(tp):
        want = jleaves[int(p["seed"][0])]
        assert set(p) == set(want)
        assert p["seed"].dtype == torch.int32 and p["seed"].shape == (1,)
        for k in p:
            assert tuple(p[k].shape) == tuple(np.asarray(want[k]).shape)
        if "mval" in p:     # a gather and one scale: bit for bit
            np.testing.assert_array_equal(p["mval"].numpy(),
                                          np.asarray(want["mval"]))
        else:
            n_matrix += 1
            np.testing.assert_allclose(p["u"].numpy(), np.asarray(want["u"]),
                                       rtol=1e-6, atol=1e-6)
    assert n_matrix == (4 if mode == "lowrank" else 0)
    got = state_to_numpy(tc.decode(tp))
    want = jax.tree.map(np.asarray, jc.decode(jp))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_mask_indices_distinct_ascending_and_seeded():
    codec = SketchCodec(FRAC).bind({"w": torch.zeros(3000)})
    a = codec._expand(torch.tensor([128], dtype=torch.int32), 0)
    b = codec._expand(torch.tensor([128], dtype=torch.int32), 0)
    c = codec._expand(torch.tensor([256], dtype=torch.int32), 0)
    assert a.dtype == torch.int64 and a.numel() == codec._k(0) == 188
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a[1:] > a[:-1]).all()) and 0 <= a[0] and a[-1] < 3000
    keys = hash_keys(torch.tensor([7]), torch.arange(1 << 16))
    assert keys.unique().numel() == 1 << 16 and int(keys.min()) >= 0
    assert int(keys.max()) < 1 << 62


@pytest.mark.parametrize("mode", ["mask", "lowrank"])
def test_own_expansion_is_unbiased(mode):
    """Mean of the decoded estimate over 2,000 seeds: within 3 standard
    errors of x for at least 99% of the coordinates, and within 4.5 for
    all (a coordinate the mask never or always picks sits far outside)."""
    rng = np.random.default_rng(0)
    x = {"m": torch.from_numpy(rng.standard_normal((6, 16)).astype(
        np.float32)), "v": torch.from_numpy(rng.standard_normal(40).astype(
            np.float32))}
    codec = SketchCodec(0.25, mode=mode).bind(x)
    u = rng.random(2000).astype(np.float32)
    out = []
    for s in u:
        noise = [torch.tensor([s])] * 2
        payload, _ = codec.encode(x, noise=noise)
        out.append(torch.cat([t.flatten() for t in
                              tree_leaves(codec.decode(payload))]))
    out = torch.stack(out).double()
    want = torch.cat([t.flatten() for t in tree_leaves(x)]).double()
    se = out.std(0) / np.sqrt(len(u))
    z = ((out.mean(0) - want) / se).abs()
    assert codec._is_matrix(0) == (mode == "lowrank")
    assert float((z <= 3).double().mean()) >= 0.99, z
    assert float(z.max()) <= 4.5, z


@functools.cache
def _jax_ref(codec):
    jb = j_make_bundle(dataclasses.replace(J_MNIST, **NARROW))
    parts, test = _data(NARROW["input_shape"], 4, 40)
    fl = JFL(clients_per_round=2, local_steps=2, local_batch=8, lr=0.05,
             uplink_codec=codec, topk_frac=FRAC)
    return j_ref(jb, fl, JFD(parts, test, seed=0), rounds=2, seed=1,
                 eval_examples=64)


@pytest.mark.parametrize("codec", ["mask", "lowrank"])
def test_bytes_per_round_equal_jax_and_engine_equals_reference(codec):
    """The uplink's bytes per round equal JAX's reference loop's; the
    port's engine (seeds staged through the noise path) equals its
    reference loop exactly; both train (finite losses)."""
    tb = make_bundle(dataclasses.replace(T_MNIST, **NARROW))
    parts, test = _data(NARROW["input_shape"], 4, 40)
    fl = TFL(clients_per_round=2, local_steps=2, local_batch=8, lr=0.05,
             uplink_codec=codec, topk_frac=FRAC)
    kw = dict(rounds=2, seed=1, eval_examples=64, device="cpu")
    ref = run_federated_reference(tb, fl, TFD(parts, test, seed=0), **kw)
    eng = run_federated(tb, fl, TFD(parts, test, seed=0),
                        superstep_rounds=2, **kw)
    jres = _jax_ref(codec)
    for ht, hj in zip(ref.comm.history, jres.comm.history):
        assert {k: ht[k] for k in BYTE_KEYS} == {k: hj[k] for k in BYTE_KEYS}
        assert np.isfinite(ht["local_loss"]) and np.isfinite(ht["loss"])
    assert ref.comm.bytes_up == jres.comm.bytes_up
    assert eng.comm.history == ref.comm.history
    for a, b in zip(tree_leaves(eng.global_state),
                    tree_leaves(ref.global_state)):
        assert torch.equal(a, b)


def test_make_codec_builds_both_with_jax_names():
    for name in ("mask", "lowrank"):
        tc = tcomp.make_codec(name, topk_frac=FRAC)
        jc = jcomp.make_codec(name, topk_frac=FRAC)
        assert isinstance(tc, SketchCodec)
        assert (tc.name, tc.mode, tc.frac, tc.stateful) == \
            (jc.name, jc.mode, jc.frac, jc.stateful)
    for kw in (dict(frac=0.0), dict(mode="dense")):
        with pytest.raises(ValueError) as terr:
            SketchCodec(**kw)
        with pytest.raises(ValueError) as jerr:
            jcomp.SketchCodec(**kw)
        assert str(terr.value) == str(jerr.value)
