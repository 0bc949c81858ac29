"""The port's adaptive compression controllers (``repro_torch.control``) and
the codecs' level ladders, against the JAX package, on the CPU.

* Controllers: ``update`` equal to JAX's over a seeded random sequence of
  metrics (levels exact, the float32 EMA / spend within 1e-6).
* Ladders and config: ``ladder_values``, ``LadderSpec``, the codecs'
  ``set_ladder`` / ``level_bytes`` and ``FLConfig``'s checks give JAX's
  values and JAX's errors.
* Codecs at a level: top-k exact at every level; quant with JAX's offsets
  bit-equal (codes and scales) to JAX's codec with the Pallas
  ``quant_pack`` in interpret mode, through ``quant_pack_multi_plain``; the
  top level bit-equal to the static encode.
* The engine against JAX's engine, each controller on a top-k ladder and
  on an int8 ladder (JAX's stochastic-rounding offsets handed in through
  ``noise_fn``): the level schedule and the CommLog's effective fields and
  bytes exactly, every float signal a level decision read farther from its
  threshold than ten times the port's distance from JAX's value of it,
  losses and telemetry within rtol 1e-4 and the final state within rtol
  1e-4 / atol 1e-5.
* Chunk size and resume: results do not depend on the chunk size; a
  resume from ``ctrl.npz`` equals the uninterrupted run bit for bit, and a
  JAX checkpoint with its ``ctrl.npz`` resumes.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compress import _jax_offsets

from repro import compress as jcomp
from repro import control as jctrl
from repro.configs import CNN_CONFIGS
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import FederatedDataset as JFD
from repro.fl.server import run_federated as j_run_federated
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch import compress as tcomp
from repro_torch import control as tctrl
from repro_torch.configs import CNN_MNIST, FLConfig
from repro_torch.data import FederatedDataset, class_images, iid_partition
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels import compress_pack as tcp
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

NARROW = dict(input_shape=(8, 8, 1), conv_channels=(4,), fc_units=(8,),
              dropout=0.0)
COMP = 0x636f6d70           # "comp": the JAX engine's codec key salt
SEED, ROUNDS = 1, 8
# engine cases: each controller on a top-k ladder and on an int8 ladder
# (ef_ratio reads the EF tap, which needs a stateful uplink: top-k only).
# The band and budget are set so that every schedule moves.
ENGINE = {
    "ef_ratio-topk": dict(controller="ef_ratio", uplink_codec="topk",
                          topk_frac=0.25, ctrl_band=(0.4, 0.9),
                          ctrl_ema=0.5),
    "loss_trend-topk": dict(controller="loss_trend", uplink_codec="topk",
                            topk_frac=0.25),
    "bytes_budget-topk": dict(controller="bytes_budget",
                              uplink_codec="topk", topk_frac=0.25),
    "loss_trend-int8": dict(controller="loss_trend", uplink_codec="int8"),
    "bytes_budget-int8": dict(controller="bytes_budget",
                              uplink_codec="int8", ctrl_budget_frac=0.75),
}


def _fl(cls=FLConfig, **kw):
    return cls(algorithm="fedavg", clients_per_round=4, local_steps=2,
               local_batch=4, lr=0.05, **kw)


@functools.cache
def _bundles():
    return (j_make_bundle(dataclasses.replace(CNN_CONFIGS["cnn_mnist"],
                                              **NARROW)),
            make_bundle(dataclasses.replace(CNN_MNIST, **NARROW)))


@functools.cache
def _parts():
    x, y = class_images(24, n_classes=4, shape=(8, 8, 1), seed=0)
    return iid_partition(x, y, 8), {"x": x[:16], "y": y[:16]}


def _data(cls=FederatedDataset):
    parts, test = _parts()
    return cls(parts, test, seed=3)


@functools.cache
def _jax_state():
    jb, _ = _bundles()
    return jax.tree.map(np.asarray, j_init_global_state(
        jb, _fl(JFL), jax.random.PRNGKey(SEED)))


def _jax_noise_fn():
    """``noise_fn(r, n_clients)`` giving the port the uplink offsets the JAX
    engine draws (key ``fold_in(fold_in(PRNGKey(seed), "comp"), r)``, split
    into downlink and uplink, the uplink split over clients, then over the
    leaves), in the port's leaf order and layout."""
    jleaves, treedef = jax.tree.flatten(_jax_state()["model"])
    sizes = [x.size for x in jleaves]

    def to_port(flat):
        tree = jax.tree.unflatten(treedef, [a.reshape(x.shape)
                                            for a, x in zip(flat, jleaves)])
        return [t.reshape(-1) for t in tree_leaves(state_from_numpy(tree))]

    def noise_fn(r, n_clients):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), COMP), r)
        _, ku = jax.random.split(key)
        return None, [to_port(_jax_offsets(k, sizes))
                      for k in jax.random.split(ku, n_clients)]

    return noise_fn


RUN = dict(seed=SEED, eval_every=2, superstep_rounds=4)


def _port_run(case, rounds=ROUNDS, **kw):
    kw = {**RUN, **kw}
    fl = _fl(**ENGINE[case])
    return run_federated(
        _bundles()[1], fl, _data(), rounds=rounds, device="cpu",
        global_state=state_from_numpy(_jax_state()),
        noise_fn=_jax_noise_fn() if fl.uplink_codec == "int8" else None,
        **kw)


@functools.cache
def _jax_run(case, rounds=ROUNDS, checkpoint_dir=None):
    return j_run_federated(_bundles()[0], _fl(JFL, **ENGINE[case]),
                           _data(JFD), rounds=rounds,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=2, **RUN)


def _assert_bitwise(a, b):
    for x, y in zip(tree_leaves(a.global_state), tree_leaves(b.global_state)):
        assert torch.equal(x, y)
    assert a.comm.history == b.comm.history


def _assert_state_close(tres, jstate):
    got = jax.tree.leaves(state_to_numpy(tres.global_state))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# registry, config, ladders
# --------------------------------------------------------------------------

def test_controller_registry_and_plugin():
    assert tctrl.registered_controllers() == jctrl.registered_controllers()
    assert isinstance(tctrl.make_controller("ef_ratio"),
                      tctrl.EFRatioController)
    with pytest.raises(ValueError, match="unknown controller"):
        tctrl.make_controller("nope")
    with pytest.raises(ValueError, match="already registered"):
        tctrl.register_controller("static", tctrl.Controller)

    class Custom(tctrl.Controller):
        name = "custom_probe_torch"

    tctrl.register_controller("custom_probe_torch", Custom)
    try:
        # config validation falls back to the live registry for plugins
        fl = FLConfig(controller="custom_probe_torch", uplink_codec="topk")
        assert fl.controller == "custom_probe_torch"
    finally:
        from repro_torch.control.controller import _REGISTRY
        _REGISTRY.pop("custom_probe_torch")
    with pytest.raises(ValueError, match="unknown controller"):
        FLConfig(controller="custom_probe_torch", uplink_codec="topk")


def _same_outcome(t_fn, j_fn):
    """Both callables return equal values, or raise the same error type
    with the same message."""
    try:
        want = j_fn()
    except Exception as e:              # noqa: BLE001 - compared below
        with pytest.raises(type(e)) as got:
            t_fn()
        assert str(got.value) == str(e)
        return None
    got = t_fn()
    assert got == want
    return got


@pytest.mark.parametrize("kw", [
    dict(controller="bogus"),
    dict(controller="ef_ratio"),                       # identity uplink
    dict(controller="ef_ratio", uplink_codec="mask"),
    dict(controller="ef_ratio", uplink_codec="topk", topk_frac=0.2,
         ladder=(0.2, 0.1)),
    dict(ladder=(0.1, 0.1)),
    dict(ctrl_band=(2.0, 0.5)),
    dict(ctrl_band=(0.5,)),
    dict(ctrl_budget_frac=0.0),
    dict(ctrl_ema=1.0),
    dict(controller="loss_trend", uplink_codec="int4", ctrl_ema=0.0,
         ctrl_band=(0.0, 1.0), ctrl_budget_frac=1.0),
], ids=["unknown", "identity", "mask", "descending", "repeated", "band",
        "band-len", "budget", "ema", "valid"])
def test_flconfig_controller_checks_match_jax(kw):
    fields = ("controller", "ladder", "ctrl_band", "ctrl_budget_frac",
              "ctrl_ema")
    _same_outcome(lambda: [getattr(FLConfig(**kw), f) for f in fields],
                  lambda: [getattr(JFL(**kw), f) for f in fields])
    assert [getattr(FLConfig(), f) for f in fields] == \
        [getattr(JFL(), f) for f in fields]            # the defaults


@pytest.mark.parametrize("kw", [
    dict(uplink_codec="topk", topk_frac=0.2),
    dict(uplink_codec="topk_noef", topk_frac=0.3, ladder=(0.1, 0.3)),
    dict(uplink_codec="int8"),
    dict(uplink_codec="int4"),
    dict(uplink_codec="quant", quant_bits=4),
    dict(uplink_codec="quant", quant_bits=8, ladder=(8,)),
    dict(uplink_codec="topk", topk_frac=0.2, ladder=(0.05, 0.1)),
    dict(uplink_codec="int8", ladder=(2, 8)),
    dict(uplink_codec="int4", ladder=(4, 8)),
    dict(uplink_codec="identity"),
], ids=["topk", "topk_noef", "int8", "int4", "quant4", "quant8",
        "top-mismatch", "bits", "int4-capacity", "identity"])
def test_ladder_values_match_jax(kw):
    _same_outcome(lambda: (tctrl.ladder_kind(kw["uplink_codec"]),
                           tctrl.ladder_values(FLConfig(**kw))),
                  lambda: (jctrl.ladder_kind(kw["uplink_codec"]),
                           jctrl.ladder_values(JFL(**kw))))


def test_ladder_spec_matches_jax():
    for kw in (dict(kind="topk_frac", values=(0.1, 0.2), bytes_up=(8,)),
               dict(kind="topk_frac", values=(), bytes_up=())):
        _same_outcome(lambda: tctrl.LadderSpec(**kw),
                      lambda: jctrl.LadderSpec(**kw))
    spec = tctrl.LadderSpec(kind="quant_bits", values=(4, 8),
                            bytes_up=(58, 108))
    assert spec.n_levels == 2
    table = spec.bytes_table()
    assert table.dtype == torch.float32
    assert np.array_equal(table.numpy(), np.asarray(
        jctrl.LadderSpec(kind="quant_bits", values=(4, 8),
                         bytes_up=(58, 108)).bytes_table()))


def _tree(seed=0):
    """A small flat tree with sorted keys (one leaf order in both
    packages), an odd leaf for int4's padding."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(40).astype(np.float32),
            "b": (2 * rng.standard_normal((3, 7))).astype(np.float32),
            "c": rng.standard_normal(11).astype(np.float32)}


def _codecs(name, **kw):
    tree = _tree()
    jc = jcomp.make_codec(name, impl="pallas_interpret", **kw).bind(tree)
    tc = tcomp.make_codec(name, **kw).bind(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    return tree, jc, tc


@pytest.mark.parametrize("name,kw,ladders", [
    ("topk", dict(topk_frac=0.4), [(0.4, 0.2), (0.1, 0.2), (0.0, 0.4),
                                   (0.1, 0.2, 0.4)]),
    ("int8", {}, [(8, 4), (2, 8), (4,), (4, 8)]),
    ("int4", {}, [(4, 8), (4,)]),
    ("identity", {}, [(0.1, 1.0)]),
], ids=["topk", "int8", "int4", "identity"])
def test_codec_set_ladder_and_level_bytes_match_jax(name, kw, ladders):
    _, jc, tc = _codecs(name, **kw)
    _same_outcome(tc.level_bytes, jc.level_bytes)       # before set_ladder
    for lad in ladders:
        _same_outcome(lambda: tc.set_ladder(lad)._ladder,
                      lambda: jc.set_ladder(lad)._ladder)
    _same_outcome(tc.level_bytes, jc.level_bytes)
    if name != "identity":
        assert tc.level_bytes()[-1] == tc.wire_bytes() == jc.wire_bytes()
    else:
        with pytest.raises(NotImplementedError):
            tc.encode({k: torch.from_numpy(v) for k, v in _tree().items()},
                      level=torch.tensor(0, dtype=torch.int32))


# --------------------------------------------------------------------------
# codecs at a level
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["topk", "topk_noef"])
def test_topk_level_encode_matches_jax(name):
    """Every level: the capacity-shaped payload (indices by decreasing
    magnitude, the slots past k_level sending 0) and the EF residual equal
    JAX's; decode + residual is the input plus the old residual; the top
    level equals the static encode."""
    tree, jc, tc = _codecs(name, topk_frac=0.4)
    ladder = (0.1, 0.2, 0.4)
    jc.set_ladder(ladder)
    tc.set_ladder(ladder)
    rng = np.random.default_rng(1)
    old = [rng.standard_normal(x.size).astype(np.float32) * 0.3
           for x in tree.values()]
    jst = ([jnp.asarray(o) for o in old] if name == "topk"
           else jc.init_state())
    tst = ([torch.from_numpy(o) for o in old] if name == "topk"
           else tc.init_state())
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for level in range(3):
        jp, js = jc.encode(jax.tree.map(jnp.asarray, tree), jst,
                           level=jnp.asarray(level, jnp.int32))
        tp, ts = tc.encode(ttree, tst,
                           level=torch.tensor(level, dtype=torch.int32))
        for t, j, x in zip(tp, jp, tree.values()):
            assert np.array_equal(t["idx"].numpy(), np.asarray(j["idx"]))
            assert np.array_equal(t["val"].numpy(), np.asarray(j["val"]))
            k_l = max(1, round(ladder[level] * x.size))
            assert int((t["val"] != 0).sum()) == k_l
        if name == "topk":
            for t, j, x, o, d in zip(ts, js, tree.values(), old,
                                     tc.decode(tp).values()):
                assert np.array_equal(t.numpy(), np.asarray(j))
                assert torch.equal(d.reshape(-1) + t, torch.from_numpy(
                    x.reshape(-1) + o))
    # the top level is the static encode (decode and residual bit-equal)
    tp_s, ts_s = tc.encode(ttree, tst)
    for a, b in zip(tc.decode(tp_s).values(), tc.decode(tp).values()):
        assert torch.equal(a, b)
    if name == "topk":
        for a, b in zip(ts_s, ts):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quant_level_encode_matches_jax(name):
    """Every level of the quant ladder, with JAX's offsets: codes and
    scales of ``quant_pack_multi_plain`` (the CPU path and the card's
    reference) and of the port's codec bit-equal to JAX's codec running
    the Pallas ``quant_pack`` in interpret mode; the top level equals the
    static encode."""
    tree, jc, tc = _codecs(name)
    bits = int(name[3:])
    ladder = (4, 8) if bits == 8 else (4,)
    jc.set_ladder(ladder)
    tc.set_ladder(ladder)
    assert tc.level_bytes() == jc.level_bytes()
    key = jax.random.PRNGKey(11)
    sizes = tc.noise_sizes()
    offsets = [torch.tensor(u) for u in _jax_offsets(key, sizes)]
    leaves = [torch.from_numpy(x.reshape(-1)) for x in tree.values()]
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    qmax = [float(2 ** (b - 1) - 1) for b in ladder]
    for level in range(len(ladder)):
        lv = torch.tensor(level, dtype=torch.int32)
        jp, _ = jc.encode(jax.tree.map(jnp.asarray, tree), jc.init_state(),
                          key, level=jnp.asarray(level, jnp.int32))
        plain = tcp.quant_pack_multi_plain(leaves, offsets, bits=bits,
                                           level=lv, ladder_qmax=qmax)
        tp, _ = tc.encode(ttree, None, offsets, level=lv)
        for (q, s), t, j in zip(plain, tp, jp):
            assert np.array_equal(q.numpy(), np.asarray(j["q"]))
            assert np.array_equal(s.numpy(), np.asarray(j["scale"]))
            assert torch.equal(t["q"], q) and torch.equal(t["scale"], s)
    top = tc.encode(ttree, None, offsets)[0]
    for a, b in zip(top, tp):
        assert torch.equal(a["q"], b["q"])
        assert torch.equal(a["scale"], b["scale"])
    with pytest.raises(ValueError, match="ladder qmax"):
        tcp.quant_pack_multi_plain(leaves, offsets, bits=bits,
                                   level=torch.tensor(0, dtype=torch.int32),
                                   ladder_qmax=[200.0])


# --------------------------------------------------------------------------
# controllers' update
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["static", "ef_ratio", "bytes_budget",
                                  "loss_trend"])
def test_controller_update_matches_jax(name):
    """A seeded random walk of metrics through both controllers: the
    levels equal, the float32 EMA / spend within 1e-6."""
    kw = dict(uplink_codec="topk", topk_frac=0.2, ctrl_band=(0.6, 1.4),
              ctrl_ema=0.7, ctrl_budget_frac=0.6)
    spec = dict(kind="topk_frac", values=(0.05, 0.1, 0.2),
                bytes_up=(104, 200, 400))
    jc = jctrl.make_controller(name).setup(jctrl.LadderSpec(**spec),
                                           JFL(**kw))
    tc = tctrl.make_controller(name).setup(tctrl.LadderSpec(**spec),
                                           FLConfig(**kw))
    js, ts = jc.init_state(), tc.init_state()
    rng = np.random.default_rng(5)
    ratio = np.float32(1.0)
    loss = np.float32(2.5)
    for _ in range(40):
        ratio = np.float32(max(0.0, ratio + rng.normal(0, 0.3)))
        loss = np.float32(loss * rng.uniform(0.9, 1.02))
        jm = {"tele/ef_delta_ratio": jnp.float32(ratio),
              "local_loss": jnp.float32(loss)}
        tm = {"tele/ef_delta_ratio": torch.tensor(ratio),
              "local_loss": torch.tensor(loss)}
        js, ts = jc.update(js, jm), tc.update(ts, tm)
        assert set(ts) == set(js)
        assert ts["level"].dtype == torch.int32
        assert int(ts["level"]) == int(js["level"])
        for k in set(ts) - {"level"}:
            assert ts[k].dtype == torch.float32
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-6)


# --------------------------------------------------------------------------
# the engine against JAX's engine
# --------------------------------------------------------------------------

def _signals(case, hist):
    """The value each round's level decision compared with its thresholds,
    recomputed (in float64) from a run's history by the controller's rule:
    ``ef_ratio``'s EMA (against the band's two edges) or ``loss_trend``'s
    relative EMA improvement (against 0.01); [] for ``bytes_budget``, whose
    rule reads no float signal."""
    fl = _fl(**ENGINE[case])
    a, out, ema = fl.ctrl_ema, [], None
    for h in hist:
        if fl.controller == "ef_ratio":
            ema = (1 - a) * h["tele/ef_delta_ratio"] + a * (ema or 0.0)
            out.append(ema)
        elif fl.controller == "loss_trend":
            loss = h["local_loss"]
            if ema is not None:
                new = a * ema + (1 - a) * loss
                out.append((ema - new) / max(abs(new), 1e-8))
            ema = loss if ema is None else new
    return out


def _assert_decision_margins(case, thist, jhist):
    """Every signal a level decision read lies farther from its thresholds
    than ten times the distance between the port's and JAX's values of it
    (plus 1e-6 of its size): the equal schedules do not rest on rounding."""
    fl = _fl(**ENGINE[case])
    edges = (fl.ctrl_band if fl.controller == "ef_ratio" else (0.01,))
    for t, j in zip(_signals(case, thist), _signals(case, jhist)):
        tol = 10 * abs(t - j) + 1e-6 * max(abs(j), 1e-3)
        assert all(abs(j - e) > tol for e in edges), (j, t, edges)


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_controller_matches_jax(case):
    jres = _jax_run(case)
    tres = _port_run(case)
    kw = ENGINE[case]
    assert tres.stats["controller"] == jres.stats["controller"] \
        == kw["controller"]
    assert tres.stats["ladder"] == jres.stats["ladder"]
    assert len(tres.comm.history) == len(jres.comm.history) == ROUNDS
    exact = ("round", "bytes_up", "bytes_down", "bytes_up_ideal",
             "cum_bytes_up", "level", "eff_topk_frac", "eff_quant_bits",
             "tele/level", "tele/effective_bytes", "tele/clients",
             "tele/clients_per_shard", "tele/weight_total")
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        assert set(ht) == set(hj)
        assert {k: ht[k] for k in exact if k in hj} == \
            {k: hj[k] for k in exact if k in hj}
        for k in set(hj) - set(exact):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    levels = [h["level"] for h in jres.comm.history]
    assert len(set(levels)) > 1, levels          # the schedule moves
    _assert_decision_margins(case, tres.comm.history, jres.comm.history)
    assert tres.comm.bytes_up == jres.comm.bytes_up
    _assert_state_close(tres, jres.global_state)


def test_controller_needs_its_tap_as_jax():
    fl = dict(uplink_codec="int8", controller="ef_ratio")
    _same_outcome(
        lambda: run_federated(_bundles()[1], _fl(**fl), _data(), rounds=1,
                              seed=SEED, device="cpu"),
        lambda: j_run_federated(_bundles()[0], _fl(JFL, **fl), _data(JFD),
                                rounds=1, seed=SEED))
    with pytest.raises(NotImplementedError, match="engine feature"):
        run_federated_reference(_bundles()[1], _fl(**ENGINE["ef_ratio-topk"]),
                                _data(), rounds=1, device="cpu")


# --------------------------------------------------------------------------
# chunk size, resume
# --------------------------------------------------------------------------

def test_controller_chunk_size_invariant():
    """The controller state is carried in place through the chunk: K = 1,
    3 and 8 give the same schedule and model, bit for bit."""
    runs = [_port_run("loss_trend-topk", superstep_rounds=k, eval_every=1)
            for k in (1, 3, 8)]
    _assert_bitwise(runs[0], runs[1])
    _assert_bitwise(runs[0], runs[2])
    assert [h["level"] for h in runs[0].comm.history] == \
        [h["level"] for h in _jax_run("loss_trend-topk").comm.history]


@pytest.mark.parametrize("store", ["device", "host"])
def test_controller_resume_bit_equal(tmp_path, store):
    """``ctrl.npz`` beside ``ef.npz``: interrupted at round 4 and resumed to
    8, model, history and schedule equal the uninterrupted run."""
    case = "ef_ratio-topk"
    oracle = _port_run(case)
    d = str(tmp_path / store)
    _port_run(case, rounds=4, checkpoint_dir=d, checkpoint_every=2,
              ef_store=store)
    assert (tmp_path / store / "ctrl.npz").exists()
    resumed = _port_run(case, checkpoint_dir=d, checkpoint_every=2)
    for a, b in zip(tree_leaves(oracle.global_state),
                    tree_leaves(resumed.global_state)):
        assert torch.equal(a, b)

    def strip(h):
        return {k: v for k, v in h.items()
                if k not in ("round", "cum_bytes_up")}

    assert [strip(h) for h in resumed.comm.history] == \
        [strip(h) for h in oracle.comm.history[4:]]


def test_jax_checkpoint_with_ctrl_resumes(tmp_path):
    """A JAX engine checkpoint at round 4 (``state.npz``, ``ef.npz``,
    ``ctrl.npz``) resumes on the port with ``checkpoint_from_jax=True``:
    rounds 5-8 give JAX's uninterrupted schedule, bytes and losses, and
    its final state."""
    case = "ef_ratio-topk"
    d = str(tmp_path / "jax")
    j_run_federated(_bundles()[0], _fl(JFL, **ENGINE[case]), _data(JFD),
                    rounds=4, checkpoint_dir=d, checkpoint_every=2, **RUN)
    assert (tmp_path / "jax" / "ctrl.npz").exists()
    tres = run_federated(_bundles()[1], _fl(**ENGINE[case]), _data(),
                         rounds=ROUNDS, device="cpu", checkpoint_dir=d,
                         checkpoint_every=2, checkpoint_from_jax=True, **RUN)
    want = _jax_run(case).comm.history[4:]
    assert [h["level"] for h in tres.comm.history] == \
        [h["level"] for h in want]
    assert [h["bytes_up"] for h in tres.comm.history] == \
        [h["bytes_up"] for h in want]
    np.testing.assert_allclose([h["local_loss"] for h in tres.comm.history],
                               [h["local_loss"] for h in want], rtol=1e-4)
    _assert_state_close(tres, _jax_run(case).global_state)
