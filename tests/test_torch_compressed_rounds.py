"""The port's compressed federated loop against the JAX package's
``run_federated_reference`` with wire codecs, seed for seed, on the CPU.

Both loops start from the same (converted) JAX initial state, sample the
same cohorts and batches, and the port gets exactly the stochastic-rounding
offsets JAX draws: the test rebuilds them from JAX's key derivation
(``fold_in(PRNGKey(seed), 0x636f6d70)``, ``fold_in(., r)``, ``split`` into
downlink and uplink keys, ``split`` over the clients, ``split`` over the
leaves, ``uniform``) and hands them to the port through ``noise_fn``, in
the port's leaf layout (conv weights OIHW).

Tolerances:

* top-k and identity codecs: slice 1's ``_check`` (final model rtol 1e-4 /
  atol 1e-5, losses alike, ``CommLog`` bytes identical).  Top-k selects
  from continuous values, so float32 drift (~1e-7 relative per step) does
  not change a selection at these sizes.
* quant codecs: ``floor(x / scale + u)`` is a step function, so the ~1e-6
  relative drift of the trained deltas between XLA and PyTorch can move a
  code by one where ``x / scale + u`` lies within that drift of an
  integer.  The round-1 codes of every client and leaf must be equal
  except for such +-1 flips, at positions where JAX's ``x / scale + u``
  is within 1e-4 of an integer, and flips may touch at most 0.1% of the
  codes.  A flip moves a parameter by one quant step times the client's
  weight, and later rounds train from the result, so the final model is
  held to atol = 2 x the largest quant step of the run (rtol 0); byte
  counts stay identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rounds import BYTE_KEYS, NARROW, _check, _data

import repro.fl.server as j_server
import repro_torch.fl.server as t_server
from repro import compress as jcomp
from repro.configs.base import FLConfig as JFL
from repro.configs.cnn_paper import CNN_MNIST as J_MNIST
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch import compress as tcomp
from repro_torch.configs import CNN_MNIST as T_MNIST
from repro_torch.configs import FLConfig as TFL
from repro_torch.data import FederatedDataset as TFD
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

COMP = 0x636f6d70           # "comp": the JAX loop's codec key salt
N_CLIENTS, C, ROUNDS, SEED = 4, 3, 3, 1


class _JaxRecQuant(jcomp.QuantCodec):
    """The JAX quant codec, recording (leaf key, leaf, x, codes, scale) of
    every leaf it encodes while the jitted round runs."""

    def __init__(self, bits, log):
        super().__init__(bits)
        self.log = log

    def _encode_leaf(self, x, state, key, i):
        p, s = super()._encode_leaf(x, state, key, i)
        jax.debug.callback(
            lambda k, xx, q, sc, i=i: self.log.append(
                (np.asarray(k).tobytes(), i, np.array(xx), np.array(q),
                 np.float32(np.asarray(sc)[0]))),
            key, x, p["q"], p["scale"])
        return p, s


class _TorchRecQuant(tcomp.QuantCodec):
    """The port's quant codec, recording (leaf, codes) in call order (a
    message encodes all its leaves at once, in leaf order)."""

    def __init__(self, bits, log):
        super().__init__(bits)
        self.log = log

    def _encode_leaves(self, leaves, state, noise):
        p, s = super()._encode_leaves(leaves, state, noise)
        self.log.extend((i, leaf["q"].clone()) for i, leaf in enumerate(p))
        return p, s


def _recording(make, cls, logs):
    def make_codec(name, **kw):
        codec = make(name, **kw)
        if name in ("int8", "int4", "quant"):
            logs.append([])
            codec = cls(codec.bits, logs[-1])
        return codec
    return make_codec


def _codes(q, bits):
    """Packed codes -> int32 codes (nibbles split, element 2i first)."""
    q = np.asarray(q)
    if bits == 8:
        return q.astype(np.int32)
    return np.stack(((q & 0xF).astype(np.int32) - 8,
                     (q >> 4).astype(np.int32) - 8), -1).reshape(-1)


def _run_both(fl_kw, mode, monkeypatch):
    jcfg = dataclasses.replace(J_MNIST, **NARROW)
    tcfg = dataclasses.replace(T_MNIST, **NARROW)
    jb, tb = j_make_bundle(jcfg), make_bundle(tcfg)
    parts, test = _data(jcfg.input_shape, N_CLIENTS, 40)
    jfl, tfl = JFL(**fl_kw), TFL(**fl_kw)
    jlogs, tlogs = [], []
    monkeypatch.setattr(j_server, "make_codec",
                        _recording(jcomp.make_codec, _JaxRecQuant, jlogs))
    monkeypatch.setattr(t_server, "make_codec",
                        _recording(tcomp.make_codec, _TorchRecQuant, tlogs))
    jres = j_server.run_federated_reference(
        jb, jfl, JFD(parts, test, seed=0), rounds=ROUNDS, seed=SEED,
        mode=mode, eval_examples=64)
    s0 = jax.tree.map(np.asarray,
                      j_init_global_state(jb, jfl, jax.random.PRNGKey(SEED)))
    jleaves, treedef = jax.tree.flatten(s0["model"])

    def to_port(flat):
        """Per-leaf flat arrays in JAX order and layout -> the port's."""
        tree = jax.tree.unflatten(treedef, [np.asarray(a).reshape(x.shape)
                                            for a, x in zip(flat, jleaves)])
        return [t.reshape(-1) for t in tree_leaves(state_from_numpy(tree))]

    sizes = [x.size for x in jleaves]
    assert all(n % 2 == 0 for n in sizes)      # no int4 padding here
    quant = ("int8", "int4", "quant")

    def round_keys(r, n_clients):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), COMP), r)
        kd, ku = jax.random.split(key)
        return kd, jax.random.split(ku, n_clients)

    def offsets(key):
        return to_port([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                        for k, n in zip(jax.random.split(key, len(sizes)),
                                        sizes)])

    def noise_fn(r, n_clients):
        kd, cks = round_keys(r, n_clients)
        return (offsets(kd) if fl_kw.get("downlink_codec") in quant
                else None,
                [offsets(ck) for ck in cks]
                if fl_kw.get("uplink_codec") in quant else None)

    tres = t_server.run_federated_reference(
        tb, tfl, TFD(parts, test, seed=0), rounds=ROUNDS, mode=mode,
        eval_examples=64, global_state=state_from_numpy(s0),
        noise_fn=noise_fn, device="cpu")
    return jres, tres, dict(jlogs=jlogs, tlogs=tlogs, to_port=to_port,
                            round_keys=round_keys, n_leaves=len(sizes),
                            up_offsets=noise_fn(0, C)[1])


def _check_quant(jres, tres, rec, fl_kw):
    """Round-1 uplink codes equal up to near-integer +-1 flips; final model
    within 2 quant steps; bytes identical."""
    bits = {"int8": 8, "int4": 4}.get(fl_kw["uplink_codec"],
                                      fl_kw.get("quant_bits", 8))
    L = rec["n_leaves"]
    _, cks = rec["round_keys"](0, C)
    leaf_keys = {np.asarray(k).tobytes(): (c, i) for c, ck in enumerate(cks)
                 for i, k in enumerate(jax.random.split(ck, L))}
    jup = {leaf_keys[k]: (x, q, s) for k, _, x, q, s in rec["jlogs"][0]
           if k in leaf_keys}
    assert len(jup) == C * L
    tup = rec["tlogs"][0][:C * L]           # round 1: clients, then leaves
    n_codes = n_flips = 0
    for c in range(C):
        x, q, s = zip(*(jup[c, i] for i in range(L)))
        want = rec["to_port"]([_codes(qi, bits) for qi in q])
        # JAX's x / scale + u, in the port's layout
        v = rec["to_port"]([xi / si for xi, si in zip(x, s)])
        for i in range(L):
            assert tup[c * L + i][0] == i
            got = torch.from_numpy(_codes(tup[c * L + i][1].numpy(), bits))
            d = got - want[i]
            flips = d != 0
            assert d.abs().max().item() <= 1, (c, i)
            vi = v[i] + rec["up_offsets"][c][i]
            near = (vi - vi.round()).abs() < 1e-4
            assert bool((near | ~flips).all()), (c, i)
            n_codes += d.numel()
            n_flips += int(flips.sum())
    assert n_flips <= 1e-3 * n_codes, (n_flips, n_codes)

    step = max(s for log in rec["jlogs"] for *_, s in log)
    want = jax.tree.map(np.asarray, jres.global_state)
    got = state_to_numpy(tres.global_state)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * step)
    assert len(tres.comm.history) == len(jres.comm.history)
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        assert {k: ht[k] for k in BYTE_KEYS} == {k: hj[k] for k in BYTE_KEYS}


TOPK = 1 / 16


@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
@pytest.mark.parametrize("algorithm", ["fedavg", "fedmmd", "fedfusion"])
def test_topk_uplink_matches_jax(algorithm, mode, monkeypatch):
    fl_kw = dict(algorithm=algorithm, fusion_op="conv", clients_per_round=C,
                 local_steps=2, local_batch=8, lr=0.05, uplink_codec="topk",
                 topk_frac=TOPK)
    jres, tres, _ = _run_both(fl_kw, mode, monkeypatch)
    _check(jres, tres, 40)


@pytest.mark.parametrize("up,down", [("topk", "topk"),
                                     ("topk_noef", "identity")])
def test_topk_variants_match_jax(up, down, monkeypatch):
    fl_kw = dict(algorithm="fedavg", clients_per_round=C, local_steps=2,
                 local_batch=8, lr=0.05, uplink_codec=up,
                 downlink_codec=down, topk_frac=TOPK)
    jres, tres, _ = _run_both(fl_kw, "client_parallel", monkeypatch)
    _check(jres, tres, 40)


@pytest.mark.parametrize("algorithm,mode,up,down", [
    ("fedl2", "client_sequential", "int8", "identity"),
    ("fedavg", "client_parallel", "int4", "int8"),
])
def test_quant_matches_jax(algorithm, mode, up, down, monkeypatch):
    fl_kw = dict(algorithm=algorithm, clients_per_round=C, local_steps=2,
                 local_batch=8, lr=0.05, uplink_codec=up,
                 downlink_codec=down)
    jres, tres, rec = _run_both(fl_kw, mode, monkeypatch)
    _check_quant(jres, tres, rec, fl_kw)
    # one encode per leaf, per client and per round (+ the downlink's)
    assert len(rec["tlogs"][0]) == ROUNDS * C * rec["n_leaves"]
    if down != "identity":
        assert len(rec["tlogs"][1]) == ROUNDS * rec["n_leaves"]
