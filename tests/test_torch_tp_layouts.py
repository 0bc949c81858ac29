"""The port's tensor-parallel LM layouts (``repro_torch.launch.sharding``,
``mesh``, ``specs``, ``steps``) against the JAX package's, and K9's
log-sum-exp and the merge of a sequence-sharded cache's partials.

Layouts are exact: every spec must equal ``tuple(PartitionSpec)`` of the
JAX package's for the same leaf, on a :class:`MeshSpec` against a
``jax.sharding.AbstractMesh`` of the same shape (the rules read only the
axis names and sizes).  Shapes are exact.  K9's plain log-sum-exp is held
to the Pallas kernel's online-softmax recurrence (``m + log l`` over its
cache blocks) at rtol 1e-6 / atol 1e-6 (float32 sums in another order;
the atol covers rows whose lse is near 0), and the merge of 2 or 4
slices' ``(o, lse)`` to the unsplit call at rtol 1e-6 / atol 1e-6 (the
merge's weighted sum rounds elements near 0 by ~1e-7), slices with no
valid position included.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import reduced
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.launch import mesh as j_mesh
from repro.launch import sharding as j_sh
from repro.launch import specs as j_specs
from repro.launch import train as j_train
from repro.models import transformer as j_tfm
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.configs import FLConfig, InputShape, get_config
from repro_torch.kernels.decode_attn import flash_decode_plain, merge_partials
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sh
from repro_torch.launch import specs as t_specs
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tfm

PORTED = ("smollm-135m", "gemma3-1b", "stablelm-3b", "h2o-danube-3-4b")
MESHES = ((1, 1), (1, 2), (2, 2), (16, 16), (2, 16, 16))
ALGOS = (("fedavg", "conv"), ("fedmmd", "conv"), ("fedl2", "conv"),
         ("fedfusion", "conv"), ("fedfusion", "multi"),
         ("fedfusion", "single"))


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def meshes(shape):
    return (t_mesh.MeshSpec(shape, _axes(shape)),
            AbstractMesh(shape, _axes(shape)))


def port_path(path):
    return tuple(p.key if hasattr(p, "key") else p.idx for p in path)


def to_port(struct):
    """A JAX ShapeDtypeStruct tree as the port's tree of torch.Size."""
    if isinstance(struct, dict):
        return {k: to_port(v) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(to_port(v) for v in struct)
    return torch.Size(struct.shape)


def j_specs_of(shardings):
    """[(port path, spec tuple)] of a tree of JAX NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return [(port_path(p), tuple(s.spec)) for p, s in flat]


def assert_specs_equal(t_tree, j_shardings):
    pairs = j_specs_of(j_shardings)
    assert pairs
    for path, want in pairs:
        assert t_sh.spec_at(t_tree, path) == want, path


def j_cfg(name, scale):
    cfg = J_ARCHS[name]
    return reduced(cfg) if scale == "reduced" else cfg


def t_cfg(name, scale):
    cfg = get_config(name)
    return reduced(cfg) if scale == "reduced" else cfg


@functools.lru_cache(maxsize=None)
def j_state(name, scale, algorithm, op):
    cfg = j_cfg(name, scale)
    fl = JFL(algorithm=algorithm, fusion_op=op)
    return jax.eval_shape(lambda k: j_init_global_state(
        j_make_bundle(cfg, jnp.float32), fl, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def j_params(name, scale):
    cfg = j_cfg(name, scale)
    return jax.eval_shape(lambda k: j_tfm.init_params(cfg, k),
                          jax.random.PRNGKey(0))


# --------------------------------------------------------------------------
# parameters and global states
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("scale", ["full", "reduced"])
@pytest.mark.parametrize("name", PORTED)
def test_param_and_state_specs_match_jax(name, scale, shape, fsdp):
    """Every algorithm's global state and the serving params (``ep`` both
    ways), leaf by leaf; the port's own state shapes equal JAX's."""
    tm, jm = meshes(shape)
    cfg = t_cfg(name, scale)
    for algorithm, op in ALGOS:
        js = j_state(name, scale, algorithm, op)
        port = t_steps.state_struct(cfg, FLConfig(algorithm=algorithm,
                                                  fusion_op=op))
        assert port == to_port(js)
        assert_specs_equal(t_sh.param_shardings(tm, port, fsdp=fsdp),
                           j_sh.param_shardings(jm, js, fsdp=fsdp))
    jp = j_params(name, scale)
    assert t_steps.param_struct(cfg) == to_port(jp)
    for ep in (False, True):
        assert_specs_equal(
            t_sh.param_shardings(tm, to_port(jp), fsdp=fsdp, ep=ep),
            j_sh.param_shardings(jm, jp, fsdp=fsdp, ep=ep))


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_param_pspec_over_every_jax_architecture(name, shape):
    """``param_pspec`` on the (path, shape) pairs of all ten JAX
    architectures' parameter trees (MoE, SSM, RG-LRU, VLM and audio
    included), ``fsdp`` and ``ep`` both ways."""
    tm, jm = meshes(shape)
    cfg = J_ARCHS[name]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda k: j_tfm.init_params(cfg, k),
                       jax.random.PRNGKey(0)))
    for fsdp in (False, True):
        for ep in (None, False, True):
            for path, leaf in flat:
                want = tuple(j_sh.param_pspec(path, leaf, jm, fsdp=fsdp,
                                              ep=ep))
                got = t_sh.param_pspec(port_path(path),
                                       torch.Size(leaf.shape), tm,
                                       fsdp=fsdp, ep=ep)
                assert got == want, (port_path(path), fsdp, ep)


# --------------------------------------------------------------------------
# caches and batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", PORTED)
def test_cache_specs_match_jax(name, shape):
    """Caches at B in {1, 4}, at lengths that split over every axis (the
    batch-1 long-context branch) and that do not; the port's cache
    shapes equal JAX's ``init_cache``'s."""
    tm, jm = meshes(shape)
    for scale in ("full", "reduced"):
        tcfg, jcfg = t_cfg(name, scale), j_cfg(name, scale)
        for B in (1, 4):
            for max_len in (1056, 4096, 97):
                js = jax.eval_shape(lambda: j_tfm.init_cache(jcfg, B,
                                                             max_len))
                port = t_tfm.cache_struct(tcfg, B, max_len)
                assert port == to_port(js)
                assert_specs_equal(t_sh.cache_shardings(tm, port),
                                   j_sh.cache_shardings(jm, js))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_plans_and_input_shapes_match_jax(kind, shape):
    """``fl_plan``, ``input_specs`` and the train / serve batch specs,
    both FL modes, batch sizes that divide the mesh and that do not."""
    tm, jm = meshes(shape)
    for name in PORTED:
        for mode in ("client_parallel", "client_sequential"):
            tcfg = dataclasses.replace(get_config(name), fl_mode=mode)
            jcfg = dataclasses.replace(J_ARCHS[name], fl_mode=mode)
            for S, B in ((64, 8), (32, 3), (16, 1), (128, 512)):
                tshape = InputShape("s", S, B, kind)
                jshape = type(J_SHAPES["train_4k"])("s", S, B, kind)
                if kind == "train":
                    assert t_specs.fl_plan(tcfg, tshape, tm).__dict__ == \
                        j_specs.fl_plan(jcfg, jshape, jm).__dict__
                jb = j_specs.input_specs(jcfg, jshape, jm, jnp.float32)
                tb = t_specs.input_specs(tcfg, tshape, tm)
                assert {k: v[0] for k, v in tb.items()} == \
                    {k: v.shape for k, v in jb.items()}
                port = {k: torch.Size(v[0]) for k, v in tb.items()}
                if kind == "train":
                    assert_specs_equal(t_sh.train_batch_shardings(tm, port),
                                       j_sh.train_batch_shardings(jm, jb))
                else:
                    assert_specs_equal(t_sh.serve_batch_shardings(tm, port),
                                       j_sh.serve_batch_shardings(jm, jb))


def test_skip_reason_and_one_device_plan_match_jax():
    for name, jcfg in J_ARCHS.items():
        for sname, jshape in J_SHAPES.items():
            tshape = InputShape(jshape.name, jshape.seq_len,
                                jshape.global_batch, jshape.kind)
            if name in PORTED:
                assert t_specs.skip_reason(get_config(name), tshape) == \
                    j_specs.skip_reason(jcfg, jshape)
            else:   # the rule reads family and blocks only
                assert (jshape.name == "long_500k"
                        and jcfg.family != "audio"
                        and not jcfg.has_subquadratic_decode) == \
                    (j_specs.skip_reason(jcfg, jshape) ==
                     "pure full-attention arch: no sub-quadratic variant")
    cfg = get_config("smollm-135m")
    shape = InputShape("s", 16, 4, "train")
    assert t_specs.fl_plan(cfg, shape) == t_specs.fl_plan(
        cfg, shape, t_mesh.MeshSpec((1, 1), ("data", "model")))


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8, 256])
def test_mesh_from_devices_rule_matches_jax(n, monkeypatch):
    """``mesh_shape_for(n)`` against JAX's ``mesh_from_devices`` with
    ``n`` devices (its ``jax.devices`` and ``jax.make_mesh`` stubbed to
    report the shape it asks for)."""
    monkeypatch.setattr(j_train.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(j_train.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    assert t_train.mesh_shape_for(n) == j_train.mesh_from_devices()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_jax(multi_pod, monkeypatch):
    monkeypatch.setattr(j_mesh, "_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    want = j_mesh.make_production_mesh(multi_pod=multi_pod)
    assert t_mesh.production_shape(multi_pod) == want
    spec = t_mesh.MeshSpec(*want)
    assert spec.axis_names == want[1] and spec.size == (512 if multi_pod
                                                        else 256)
    assert t_mesh.axis_size(spec, "pod", "data") == j_mesh.axis_size(
        AbstractMesh(*want), "pod", "data")
    assert t_mesh.batch_axes(spec) == j_mesh.batch_axes(AbstractMesh(*want))
    assert t_mesh.client_axes(spec) == j_mesh.client_axes(
        AbstractMesh(*want))


def test_production_mesh_needs_its_ranks_and_meshspec_holds_none():
    """On a one-rank group ``make_production_mesh`` raises ``ValueError``
    naming the 256 ranks it wants; a ``MeshSpec`` has no ranks to place."""
    with pytest.raises(ValueError, match="256"):
        t_mesh.make_production_mesh(device="cpu")
    spec = t_mesh.MeshSpec((2, 2), ("data", "model"))
    with pytest.raises(TypeError, match="MeshSpec"):
        t_mesh.client_position(spec)
    with pytest.raises(TypeError):
        t_mesh.axis_size(object(), "data")


# --------------------------------------------------------------------------
# K9's log-sum-exp and the merge of a sequence-sharded cache's partials
# --------------------------------------------------------------------------

def pallas_lse(q, k, valid, block_l):
    """``m + log l`` of the Pallas decode kernel's online softmax over
    cache blocks of ``block_l`` (src/repro/kernels/decode_attn.py)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qh = jnp.asarray(q).reshape(B, KV, rep, hd)
    kk = jnp.asarray(k)
    L = kk.shape[1]
    m = jnp.full((B, KV, rep), -1e30, jnp.float32)
    l = jnp.zeros((B, KV, rep), jnp.float32)
    for j0 in range(0, L, block_l):
        kb = kk[:, j0:j0 + block_l]
        s = jnp.einsum("bgrd,blgd->bgrl", qh, kb) * hd ** -0.5
        pos = j0 + jnp.arange(kb.shape[1])
        s = jnp.where(pos < valid, s, -1e30)
        m_new = jnp.maximum(m, s.max(-1))
        l = l * jnp.exp(m - m_new) + jnp.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    return np.asarray((m + jnp.log(l)).reshape(B, H))


def decode_inputs(B, L, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,L,H,KV,hd", [(2, 96, 4, 1, 64),
                                         (1, 40, 8, 2, 80),
                                         (2, 70, 6, 6, 120)])
def test_decode_lse_plain_matches_pallas_math(B, L, H, KV, hd):
    q, k, v = decode_inputs(B, L, H, KV, hd, seed=L)
    for valid in (0, 1, L // 3, L):
        o, lse = flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), valid,
                                    want_lse=True)
        assert lse.shape == (B, H) and lse.dtype == torch.float32
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        np.testing.assert_allclose(lse.numpy(), pallas_lse(q, k, valid, 32),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(o, flash_decode_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            valid))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("valid", [1, 5, 17, 40, 64])
def test_merge_of_slices_equals_the_whole(n, valid):
    """The cache cut into ``n`` slices, each attended up to ``clamp(valid
    - offset, 0, L_loc)`` (so later slices are empty at small ``valid``),
    merged: equal to the unsplit call."""
    B, L, H, KV, hd = 2, 64, 8, 2, 64
    q, k, v = (torch.from_numpy(a) for a in decode_inputs(B, L, H, KV, hd,
                                                          seed=valid))
    whole = flash_decode_plain(q, k, v, valid)
    L_loc = L // n
    parts = [flash_decode_plain(
        q, k[:, r * L_loc:(r + 1) * L_loc], v[:, r * L_loc:(r + 1) * L_loc],
        max(0, min(valid - r * L_loc, L_loc)), want_lse=True)
        for r in range(n)]
    got = merge_partials(torch.stack([o for o, _ in parts]),
                         torch.stack([lse for _, lse in parts]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# the step builders' shapes and refusals
# --------------------------------------------------------------------------

def test_step_builders_shapes_and_the_fsdp_refusal():
    """``build_step`` on one device returns the JAX builders' argument
    shapes (the whole state, batch, cache) and no layouts; a
    client-sequential round on a mesh with ``data`` > 1 (the FSDP layout
    splits leaves over it), once refused, builds with JAX's layouts: its
    state in and out ``param_shardings(..., fsdp=True)`` and its batch
    ``train_batch_shardings``, leaf by leaf against JAX's on an
    ``AbstractMesh`` of the same shape (its rounds run in
    ``tests/test_torch_mesh.py``)."""
    cfg = reduced(get_config("smollm-135m"))
    jcfg = reduced(J_ARCHS["smollm-135m"])
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv")
    train = InputShape("t", 16, 4, "train")
    fn, args, lin, lout = t_steps.build_step(cfg, fl, train)
    assert callable(fn) and lin is None and lout is None
    assert args[0] == to_port(j_state("smollm-135m", "reduced", "fedfusion",
                                      "conv"))
    assert args[1]["tokens"] == ((1, 2, 4, 16), torch.int64)
    fn, args, lin, _ = t_steps.build_step(cfg, fl,
                                          InputShape("p", 16, 4, "prefill"))
    assert args[0] == to_port(j_params("smollm-135m", "reduced"))
    assert lin is None
    fn, args, _, _ = t_steps.build_step(cfg, fl,
                                        InputShape("d", 48, 4, "decode"))
    assert args[2] == to_port(jax.eval_shape(
        lambda: j_tfm.init_cache(jcfg, 4, 48)))
    seq = dataclasses.replace(cfg, fl_mode="client_sequential")
    tm, jm = meshes((2, 2))
    fn, args, lin, lout = t_steps.build_train_step(seq, fl, train, tm)
    assert callable(fn) and lout[0] is lin[0]
    js = j_state("smollm-135m", "reduced", "fedfusion", "conv")
    assert args[0] == to_port(js)
    assert_specs_equal(lin[0], j_sh.param_shardings(jm, js, fsdp=True))
    assert "data" in t_sh.spec_axes(lin[0]["model"]["embed"]["table"][1])
    jb = j_specs.input_specs(
        dataclasses.replace(jcfg, fl_mode="client_sequential"),
        type(J_SHAPES["train_4k"])("t", 16, 4, "train"), jm, jnp.float32)
    assert_specs_equal(lin[1], j_sh.train_batch_shardings(jm, jb))
