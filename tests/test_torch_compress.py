"""The port's wire codecs and their kernels' plain versions (K3
``quant_pack``, K4 ``quant_unpack``, K5 ``topk_select``) against the JAX
package on the CPU: the Pallas kernels in interpret mode, the jnp oracles
in ``repro.kernels.ref`` and the JAX codecs.

Everything here is held to exact equality: the codes, scales, unpacked
values, top-k payloads, residuals and wire sizes are the results of the
same IEEE float32 operations (a division, an add, a floor, a clamp, one
multiply) on the same inputs, so any difference is a fault.  The
stochastic-rounding offsets are the ones JAX draws, handed to the port as
inputs (``jax.random`` cannot be reproduced in PyTorch).  Top-k inputs are
tie-free where the two frameworks could order ties differently, and index
sets are sorted before they are compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOPK_EDGE_T, topk_edge_case

from repro import compress as jcomp
from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.compress_pack import quant_pack as j_quant_pack
from repro.kernels.compress_pack import topk_select as j_topk_select
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch import compress as tcomp
from repro_torch.configs import FLConfig as TFL
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import compress_pack as tcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tree import tree_leaves


def _quant_inputs(n, bits, seed, clamp=False):
    """x ~ N(0, 1) float32, offsets in [0, 1) and the codec's scale;
    ``clamp`` halves the scale so the largest entries hit +-qmax."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    u = rng.random(n, dtype=np.float32)
    qmax = 127 if bits == 8 else 7
    scale = np.float32(np.abs(x).max()) / np.float32(qmax)
    if clamp:
        scale = np.float32(scale * np.float32(0.5))
    return x, u, np.float32(scale)


QUANT_CASES = [(8, 10), (8, 1001), (8, 2048), (8, 4097), (4, 10),
               (4, 2048), (4, 4098)]


@pytest.mark.parametrize("clamp", [False, True], ids=["scaled", "clamped"])
@pytest.mark.parametrize("bits,n", QUANT_CASES)
def test_quant_pack_unpack_plain_match_pallas_and_ref(bits, n, clamp):
    x, u, scale = _quant_inputs(n, bits, 10 * n + bits, clamp)
    want = np.asarray(jops.quantize_pack(jnp.asarray(x), scale,
                                         jnp.asarray(u), bits=bits,
                                         impl="pallas_interpret"))
    assert np.array_equal(want, np.asarray(jref.quant_pack_ref(
        jnp.asarray(x), scale, jnp.asarray(u), bits=bits)))
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    ts = torch.tensor([scale])
    got = tcp.quant_pack_plain(tx, ts, tu, bits=bits)
    assert got.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tref.quant_pack_ref(tx, ts, tu, bits=bits), got)
    assert torch.equal(tcp.quant_pack(tx, ts, tu, bits=bits), got)
    assert torch.equal(tops.quantize_pack(tx, float(scale), tu, bits=bits),
                       got)
    if clamp:
        codes = got.int() if bits == 8 else torch.stack(
            ((got & 0xF).int() - 8, (got >> 4).int() - 8), -1)
        assert codes.abs().max().item() == (127 if bits == 8 else 7)
    # unpack: exact, the same single multiply on the same codes
    want_y = np.asarray(jops.quantize_unpack(jnp.asarray(want), scale,
                                             bits=bits, n=n,
                                             impl="pallas_interpret"))
    got_y = tcp.quant_unpack_plain(got, ts, bits=bits, n=n)
    assert got_y.dtype == torch.float32 and got_y.shape == (n,)
    assert np.array_equal(got_y.numpy(), want_y)
    assert torch.equal(tref.quant_unpack_ref(got, ts, bits=bits, n=n), got_y)
    assert torch.equal(tops.quantize_unpack(got, float(scale), bits=bits,
                                            n=n), got_y)


@pytest.mark.parametrize("bits,sizes", [
    (8, [800, 32, 3, 1001]),                   # mixed sizes
    (4, [7, 4097, 10, 1]),                     # odd int4 leaves
    (4, [5 if i % 2 else 8 for i in range(70)]),  # more than a launch holds
], ids=["int8-mixed", "int4-odd", "int4-70-leaves"])
def test_quant_unpack_multi_plain_matches_pallas(bits, sizes):
    """K4's message decode (one launch per 64 leaves on the card) against
    the Pallas ``quant_unpack`` kernel in interpret mode, leaf by leaf:
    exact."""
    packed, scales, want = [], [], []
    for i, n in enumerate(sizes):
        x, u, scale = _quant_inputs(n + (n % 2 if bits == 4 else 0), bits,
                                    100 * i + n)
        q = tcp.quant_pack_plain(torch.from_numpy(x), torch.tensor([scale]),
                                 torch.from_numpy(u), bits=bits)
        packed.append(q)
        scales.append(torch.tensor([scale]))
        want.append(np.asarray(jops.quantize_unpack(
            jnp.asarray(q.numpy()), scale, bits=bits, n=n,
            impl="pallas_interpret")))
    got = tcp.quant_unpack_multi_plain(packed, scales, bits=bits, ns=sizes)
    assert len(got) == len(sizes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w)
    # the dispatching wrapper takes the plain version for CPU tensors
    for g, w in zip(tcp.quant_unpack_multi(packed, scales, bits=bits,
                                           ns=sizes), got):
        assert torch.equal(g, w)


def test_quant_unpack_refuses_n_beyond_the_codes():
    q = torch.zeros(5, dtype=torch.uint8)
    assert tcp.quant_unpack_plain(q, torch.ones(1), bits=4, n=9).shape == (9,)
    with pytest.raises(ValueError, match="outside"):
        tcp.quant_unpack_plain(q, torch.ones(1), bits=4, n=11)
    with pytest.raises(ValueError, match="even"):
        tcp.quant_pack_plain(torch.zeros(3), torch.ones(1), torch.zeros(3),
                             bits=4)
    with pytest.raises(ValueError, match="bits"):
        tcp.quant_pack_plain(torch.zeros(4), torch.ones(1), torch.zeros(4),
                             bits=2)


def _message_tree(seed):
    """A message's leaves: odd counts (int4 pads them), a leaf of all zeros
    (its scale is 1e-12 / qmax), a one-element leaf and a 4097-element one,
    in sorted key order so both packages flatten them alike."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(11).astype(np.float32),
            "b": rng.standard_normal((6, 5)).astype(np.float32),
            "c": np.zeros(7, np.float32),
            "d": (3 * rng.standard_normal(4097)).astype(np.float32),
            "e": np.float32([-0.25])}


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["offsets", "deterministic"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_pack_multi_plain_matches_jax(bits, stochastic):
    """K3's message encode (two launches on the card) against the JAX quant
    codec's encode and, leaf by leaf, the Pallas ``quant_pack`` kernel in
    interpret mode on JAX's scale: codes and scales exactly equal."""
    tree = _message_tree(5)
    jc = jcomp.make_codec(f"int{bits}").bind(tree)
    key = jax.random.PRNGKey(7) if stochastic else None
    jpay, _ = jc.encode(jax.tree.map(jnp.asarray, tree), jc.init_state(),
                        key)
    leaves = [x.reshape(-1) for x in jax.tree.leaves(tree)]
    sizes = [x.size + (x.size % 2 if bits == 4 else 0) for x in leaves]
    offsets = (_jax_offsets(key, sizes) if stochastic
               else [np.full(n, 0.5, np.float32) for n in sizes])
    got = tcp.quant_pack_multi_plain(
        [torch.from_numpy(x) for x in leaves],
        [torch.tensor(u) for u in offsets] if stochastic else None,
        bits=bits)
    qmax = 127 if bits == 8 else 7
    assert len(got) == len(leaves)
    for (q, s), jp, x, u, pn in zip(got, jpay, leaves, offsets, sizes):
        assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
        assert np.array_equal(q.numpy(), np.asarray(jp["q"]))
        assert s.shape == (1,)
        assert np.array_equal(s.numpy(), np.asarray(jp["scale"]))
        xp = jnp.pad(jnp.asarray(x), (0, pn - x.size))
        scale = jnp.maximum(jnp.max(jnp.abs(xp)), 1e-12) / qmax
        assert np.array_equal(s.numpy(), np.asarray(scale).reshape(1))
        want = j_quant_pack(xp, scale, jnp.asarray(u), bits=bits,
                            interpret=True)
        assert np.array_equal(q.numpy(), np.asarray(want))
    zero_scale = got[2][1]
    assert torch.equal(zero_scale, torch.tensor([1e-12]) / qmax)
    # the dispatching wrapper takes the plain version for CPU tensors
    for (q, s), (q2, s2) in zip(got, tcp.quant_pack_multi(
            [torch.from_numpy(x) for x in leaves],
            [torch.tensor(u) for u in offsets] if stochastic else None,
            bits=bits)):
        assert torch.equal(q, q2) and torch.equal(s, s2)


def _per_leaf_encode(x, noise, bits):
    """QuantCodec's per-leaf encode before the message hook: pad an odd
    int4 leaf, the scale by eager ops, u = 0.5 without offsets, K3."""
    n = x.shape[0]
    pn = n + (n % 2 if bits == 4 else 0)
    if pn != n:
        x = torch.nn.functional.pad(x, (0, pn - n))
    scale = (x.abs().amax().clamp_min(1e-12)
             / (127 if bits == 8 else 7)).reshape(1)
    if noise is None:
        noise = torch.full((pn,), 0.5)
    return tcp.quant_pack_plain(x, scale, noise, bits=bits), scale


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["offsets", "deterministic"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_codec_message_hook_equals_per_leaf_encode(bits, stochastic):
    """The port's QuantCodec encodes a message through ``_encode_leaves``
    (one ``quant_pack_multi`` call); its payload equals the per-leaf
    encode it replaced exactly, and its wire size is unchanged."""
    tree = state_from_numpy(_message_tree(6))
    codec = tcomp.QuantCodec(bits).bind(tree)
    rng = np.random.default_rng(bits)
    noise = ([torch.from_numpy(rng.random(n, dtype=np.float32))
              for n in codec.noise_sizes()] if stochastic else None)
    payload, state = codec.encode(tree, None, noise)
    assert state == [None] * len(payload)
    leaves = [x.reshape(-1).float() for x in tree_leaves(tree)]
    for i, (p, x) in enumerate(zip(payload, leaves)):
        q, scale = _per_leaf_encode(x, None if noise is None else noise[i],
                                    bits)
        assert p["q"].dtype == q.dtype and torch.equal(p["q"], q)
        assert p["scale"].shape == (1,) and torch.equal(p["scale"], scale)
    assert codec.nbytes(payload) == codec.wire_bytes()


def test_quant_pack_multi_refuses_bad_inputs():
    x = [torch.zeros(4), torch.ones(3)]
    with pytest.raises(ValueError, match="bits"):
        tcp.quant_pack_multi_plain(x, None, bits=2)
    with pytest.raises(ValueError, match="bits"):
        tcp.quant_pack_multi_cuda(x, None, bits=2)
    with pytest.raises(ValueError, match="offsets"):
        tcp.quant_pack_multi_cuda(x, [torch.zeros(4)], bits=8)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.quant_pack_multi_cuda(x, None, bits=8)


@pytest.mark.parametrize("n,k", [(10, 3), (1001, 40), (4096, 400),
                                 (1500, 1)])
def test_topk_select_plain_matches_pallas_and_ref(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal(n).astype(np.float32)
    t = np.sort(np.abs(x))[-k]
    x[0], x[-1] = -t, t            # entries exactly at the threshold
    want = np.asarray(jops.topk_threshold_select(jnp.asarray(x), t,
                                                 impl="pallas_interpret"))
    assert np.array_equal(want, np.asarray(jref.topk_select_ref(
        jnp.asarray(x), t)))
    tx = torch.from_numpy(x)
    got = tcp.topk_select_plain(tx, torch.tensor([t]))
    assert np.array_equal(got.numpy(), want)
    assert got[0].item() == -t and got[-1].item() == t      # |x| == t kept
    assert torch.equal(tref.topk_select_ref(tx, torch.tensor(t)), got)
    assert torch.equal(tcp.topk_select(tx, torch.tensor([t])), got)
    assert torch.equal(tops.topk_threshold_select(tx, float(t)), got)


@pytest.mark.parametrize("case", TOPK_EDGE_T)
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 2049])
def test_topk_select_plain_matches_pallas_on_edges(n, case):
    """K5's plain version against the Pallas ``topk_select`` in interpret
    mode and both packages' jnp / torch oracles, bit for bit (compared as
    uint32, so -0.0 and +0.0 differ): NaN gives 0, +-inf are kept unless
    t = +inf keeps only them, -0.0 stays -0.0 where |x| >= t, ties at t
    are kept."""
    x, t = topk_edge_case(n, case)
    want = np.asarray(j_topk_select(jnp.asarray(x), t, interpret=True))
    assert want.dtype == np.float32 and want.shape == (n,)
    bits = want.view(np.uint32)
    assert np.array_equal(np.asarray(jref.topk_select_ref(
        jnp.asarray(x), t)).view(np.uint32), bits)
    tx, tt = torch.from_numpy(x), torch.tensor([t])
    for got in (tcp.topk_select_plain(tx, tt), tcp.topk_select(tx, tt),
                tref.topk_select_ref(tx, torch.tensor(t))):
        assert np.array_equal(got.numpy().view(np.uint32), bits)
    keep = np.abs(x) >= t
    assert not np.isnan(want).any()
    assert np.array_equal(want[keep].view(np.uint32),
                          x[keep].view(np.uint32))
    assert not want[~keep].view(np.uint32).any()       # +0.0 elsewhere


# --------------------------------------------------------------------------
# the codecs against the JAX codecs
# --------------------------------------------------------------------------

def _tree(seed):
    """A tree with an odd leaf (11), a 4097-element one and a 2-D one, in
    sorted key order so both packages flatten it alike."""
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(11).astype(np.float32),
            "deep": {"v": rng.standard_normal(130).astype(np.float32)},
            "w": rng.standard_normal((37, 24)).astype(np.float32),
            "z": rng.standard_normal(4097).astype(np.float32)}


def _jax_offsets(key, sizes):
    """The offsets the JAX quant codec draws for ``key``: one split per
    leaf (``codec.py:113``), then ``uniform(k, (pn,))`` (``quant.py:45``)."""
    return [np.asarray(jax.random.uniform(k, (n,), jnp.float32))
            for k, n in zip(jax.random.split(key, len(sizes)), sizes)]


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["offsets", "deterministic"])
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quant_codec_matches_jax(name, stochastic):
    tree = _tree(3)
    jc = jcomp.make_codec(name).bind(tree)
    tc = tcomp.make_codec(name).bind(state_from_numpy(tree))
    key = jax.random.PRNGKey(11) if stochastic else None
    jpay, _ = jc.encode(jax.tree.map(jnp.asarray, tree), jc.init_state(),
                        key)
    noise = (None if key is None else
             [torch.tensor(u) for u in _jax_offsets(key, tc.noise_sizes())])
    tpay, state = tc.encode(state_from_numpy(tree), None, noise)
    assert state == [None] * 4
    for jp, tp in zip(jpay, tpay):
        assert np.array_equal(tp["q"].numpy(), np.asarray(jp["q"]))
        assert np.array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))
    for got, want in zip(tree_leaves(tc.decode(tpay)),
                         jax.tree.leaves(jc.decode(jpay))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert tc.nbytes(tpay) == jc.nbytes(jpay) == tc.wire_bytes() \
        == jc.wire_bytes()


@pytest.mark.parametrize("error_feedback", [True, False],
                         ids=["ef", "noef"])
def test_topk_codec_matches_jax(error_feedback):
    name = "topk" if error_feedback else "topk_noef"
    jc = jcomp.make_codec(name, topk_frac=0.1).bind(_tree(0))
    tc = tcomp.make_codec(name, topk_frac=0.1).bind(state_from_numpy(_tree(0)))
    jstate, tstate = jc.init_state(), tc.init_state()
    for step in range(2):                # the second encode reads the EF
        tree = _tree(step)
        jpay, jstate = jc.encode(jax.tree.map(jnp.asarray, tree), jstate)
        tpay, tstate = tc.encode(state_from_numpy(tree), tstate)
        for jp, tp in zip(jpay, tpay):
            assert tp["idx"].dtype == torch.int32
            jo, to = np.argsort(np.asarray(jp["idx"])), np.argsort(
                tp["idx"].numpy())
            assert np.array_equal(tp["idx"].numpy()[to],
                                  np.asarray(jp["idx"])[jo])
            assert np.array_equal(tp["val"].numpy()[to],
                                  np.asarray(jp["val"])[jo])
        for got, want in zip(tree_leaves(tc.decode(tpay)),
                             jax.tree.leaves(jc.decode(jpay))):
            assert np.array_equal(got.numpy(), np.asarray(want))
        if error_feedback:
            for got, want in zip(tstate, jstate):
                assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            assert tstate == [None] * 4
        assert tc.nbytes(tpay) == jc.nbytes(jpay) == tc.wire_bytes()


def test_topk_residual_is_the_exact_complement_under_ties():
    tc = tcomp.make_codec("topk", topk_frac=0.25).bind({"v": torch.zeros(8)})
    x = torch.tensor([1.0, -1.0, 1.0, 1.0, 0.5, 0.0, -1.0, 2.0])
    pay, (res,) = tc.encode({"v": x})
    sent = tc.decode(pay)["v"]
    assert torch.equal(sent + res, x)
    assert (sent != 0).sum().item() == 2 and sent[7].item() == 2.0


@pytest.fixture(scope="module")
def mnist_model():
    jb = j_make_bundle(J_MNIST)
    s = j_init_global_state(jb, JFL(), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, s["model"])


# per-message bytes at CNN_MNIST's published width (1,663,370 parameters
# in 8 leaves)
MNIST_WIRE = [("identity", {}, 6_653_480), ("int8", {}, 1_663_402),
              ("int4", {}, 831_717), ("quant", dict(quant_bits=4), 831_717),
              ("quant", {}, 1_663_402),
              ("topk", dict(topk_frac=1 / 16), 831_688),
              ("topk_noef", dict(topk_frac=1 / 16), 831_688),
              ("topk", {}, 665_360)]


@pytest.mark.parametrize("name,kw,want", MNIST_WIRE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(MNIST_WIRE)])
def test_wire_bytes_match_jax_at_full_width(mnist_model, name, kw, want):
    jc = jcomp.make_codec(name, **kw).bind(mnist_model)
    model = state_from_numpy(mnist_model)
    tc = tcomp.make_codec(name, **kw).bind(model)
    assert len(tree_leaves(model)) == 8
    assert tc.wire_bytes() == jc.wire_bytes() == want
    payload, _ = tc.encode(model)
    assert tc.nbytes(payload) == want


MAKE_ERRORS = [("topk", dict(topk_frac=0.0)), ("topk_noef",
                                               dict(topk_frac=1.5)),
               ("mask", dict(topk_frac=0.0)), ("lowrank", dict(topk_frac=-1)),
               ("quant", dict(quant_bits=5)), ("int16", {}), ("bogus", {})]


@pytest.mark.parametrize("name,kw", MAKE_ERRORS,
                         ids=[n for n, _ in MAKE_ERRORS])
def test_make_codec_errors_match_jax(name, kw):
    with pytest.raises(ValueError) as jerr:
        jcomp.make_codec(name, **kw)
    with pytest.raises(ValueError) as terr:
        tcomp.make_codec(name, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["mask", "lowrank"])
def test_sketch_codecs_are_not_ported(name):
    """The sketch codecs are ported since (the name predates that):
    ``make_codec`` builds them with JAX's names and fractions
    (``tests/test_torch_sketch.py`` holds them to JAX's wire format)."""
    jc = jcomp.make_codec(name)
    tc = tcomp.make_codec(name)
    assert (tc.name, tc.mode, tc.frac) == (jc.name, jc.mode, jc.frac)


def test_codec_names_and_config_fields_match_jax():
    assert tcomp.CODEC_NAMES == jcomp.CODEC_NAMES
    for kw in (dict(topk_frac=0.0), dict(topk_frac=1.01),
               dict(quant_bits=16)):
        with pytest.raises(ValueError) as jerr:
            JFL(**kw)
        with pytest.raises(ValueError) as terr:
            TFL(**kw)
        assert str(terr.value) == str(jerr.value)
    t, j = TFL(), JFL()
    assert (t.topk_frac, t.quant_bits) == (j.topk_frac, j.quant_bits)
    assert dataclasses.replace(t, uplink_codec="int4").compressed
