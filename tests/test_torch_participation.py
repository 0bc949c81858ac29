"""Participation policies and chaos injection on the port
(``repro_torch.fl.participation``, ``repro_torch.data.federated``'s chaos
layer, the engine's participation path), on the CPU.

The port's versions of ``tests/test_participation.py``'s pins (without
telemetry, which is not ported yet), and the port against the JAX package:
the policies' arithmetic and the chaos streams equal JAX's draw for draw,
and ``run_federated`` under ``deadline`` / ``buffered_async`` with chaos
gives JAX's history (``sim_time`` / ``arrived`` and bytes exactly, losses
within rtol 1e-4) and final state (rtol 1e-4 / atol 1e-5).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import CNN_CONFIGS
from repro.configs.base import FLConfig as JFL
from repro.core import init_global_state as j_init_global_state
from repro.data.federated import ChaosConfig as JChaos
from repro.data.federated import FederatedDataset as JFD
from repro.fl import participation as jpart
from repro.fl.server import run_federated as j_run_federated
from repro.models.registry import make_bundle as j_make_bundle
from repro_torch.chaos import ChaosConfig
from repro_torch.compress import make_codec
from repro_torch.configs import CNN_MNIST, FLConfig
from repro_torch.core.rounds import (init_global_state,
                                     make_compressed_round_fn)
from repro_torch.data import FederatedDataset, class_images, iid_partition
from repro_torch.fl.participation import (BufferedAsyncPolicy,
                                          DeadlinePolicy, FullSyncPolicy,
                                          ParticipationPolicy, make_policy,
                                          register_policy,
                                          registered_policies)
from repro_torch.fl.server import run_federated, run_federated_reference
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

NARROW = dict(input_shape=(8, 8, 1), conv_channels=(4,), fc_units=(8,),
              dropout=0.0)
CHAOS_KW = dict(speed_sigma=1.0, jitter=0.2, dropout=0.3, truncation=0.3,
                seed=7)
CHAOS = ChaosConfig(**CHAOS_KW)


@functools.cache
def _bundle():
    return make_bundle(dataclasses.replace(CNN_MNIST, **NARROW))


@functools.cache
def _parts():
    x, y = class_images(24, n_classes=4, shape=(8, 8, 1), seed=0)
    return iid_partition(x, y, 8), {"x": x[:16], "y": y[:16]}


def _data(seed=3, chaos=None, cls=FederatedDataset):
    parts, test = _parts()
    return cls(parts, test, seed=seed, chaos=chaos)


def _fl(cls=FLConfig, **kw):
    kw.setdefault("clients_per_round", 4)
    kw.setdefault("lr", 0.05)
    return cls(algorithm=kw.pop("algorithm", "fedavg"), local_steps=2,
               local_batch=4, **kw)


RUN = dict(seed=1, eval_every=2, device="cpu")


def _same_state(a, b):
    for x, y in zip(tree_leaves(a.global_state), tree_leaves(b.global_state)):
        assert torch.equal(x, y)


def _full_sync(fl):
    return lambda d: FullSyncPolicy().select(
        np.ones(4, np.float32) if d is None else d.arrival,
        np.zeros(4, bool) if d is None else d.dropped, fl, 4)


# --------------------------------------------------------------------------
# registry and policy arithmetic
# --------------------------------------------------------------------------

def test_participation_registry():
    assert set(registered_policies()) >= {"full_sync", "deadline",
                                          "buffered_async"}
    assert isinstance(make_policy("deadline"), DeadlinePolicy)
    with pytest.raises(ValueError, match="unknown participation policy"):
        make_policy("nope")

    class Custom(ParticipationPolicy):
        name = "custom_probe"
        select = FullSyncPolicy.select

    register_policy("custom_probe", Custom)
    assert isinstance(make_policy("custom_probe"), Custom)
    with pytest.raises(ValueError, match="already registered"):
        register_policy("custom_probe", Custom)
    register_policy("custom_probe", Custom, overwrite=True)
    # config validation falls back to the live registry for plugins
    assert _fl(participation="custom_probe").participation == "custom_probe"
    with pytest.raises(ValueError, match="unknown participation"):
        _fl(participation="definitely_not_registered")


@pytest.mark.parametrize("kw", [dict(over_provision=0.5),
                                dict(buffer_k=-1),
                                dict(staleness_alpha=-0.1)],
                         ids=["over_provision", "buffer_k", "alpha"])
def test_participation_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JFL(**kw)
    with pytest.raises(ValueError) as terr:
        FLConfig(**kw)
    assert str(terr.value) == str(jerr.value)
    fl, jfl = FLConfig(), JFL()
    assert (fl.over_provision, fl.buffer_k, fl.staleness_alpha) == \
        (jfl.over_provision, jfl.buffer_k, jfl.staleness_alpha)


def test_participation_policy_math():
    fl = _fl(over_provision=1.5, buffer_k=2, staleness_alpha=0.5)
    arrival = np.array([1.0, 4.0, 0.5, 2.0, 8.0, 0.25], np.float32)
    dropped = np.array([False, False, True, False, False, False])

    full = FullSyncPolicy().select(arrival, dropped, fl, 4)
    assert full.round_time == pytest.approx(8.0)   # slowest survivor
    assert full.n_arrived == 5
    assert full.mask.tolist() == [1, 1, 0, 1, 1, 1]
    assert full.weight.tolist() == [1] * 6 and full.staleness.max() == 0

    dl = DeadlinePolicy()
    assert dl.cohort_size(4, fl) == 6
    sel = dl.select(arrival, dropped, fl, 4)
    # 4 fastest ALIVE clients: 0.25, 1.0, 2.0, 4.0 (0.5 is dropped)
    assert sel.mask.tolist() == [1, 1, 0, 1, 0, 1]
    assert sel.round_time == pytest.approx(4.0)
    assert sel.n_arrived == 4

    ba = BufferedAsyncPolicy().select(arrival, dropped, fl, 4)
    # K=2: the round closes at the 2nd alive arrival, t=1.0; laggards are
    # staleness-discounted but still contribute
    assert ba.round_time == pytest.approx(1.0)
    assert ba.mask.tolist() == [1, 1, 0, 1, 1, 1]
    s = ba.staleness
    assert s[0] == pytest.approx(0.0) and s[5] == pytest.approx(0.0)
    assert s[1] == pytest.approx(3.0) and s[4] == pytest.approx(7.0)
    np.testing.assert_allclose(ba.weight, (1 + s) ** -0.5, rtol=1e-6)

    # all-dropped guard: the fastest client is un-dropped
    sel = FullSyncPolicy().select(np.array([3.0, 1.0, 2.0], np.float32),
                                  np.array([True, True, True]), fl, 3)
    assert sel.mask.tolist() == [0, 1, 0] and sel.n_arrived == 1


@pytest.mark.parametrize("name", ["full_sync", "deadline", "buffered_async"])
def test_policies_equal_jax_on_random_draws(name):
    rng = np.random.default_rng(len(name))
    fl = _fl(buffer_k=3, staleness_alpha=0.7, over_provision=1.5)
    jfl = _fl(JFL, buffer_k=3, staleness_alpha=0.7, over_provision=1.5)
    mine, theirs = make_policy(name), jpart.make_policy(name)
    assert mine.cohort_size(10, fl) == theirs.cohort_size(10, jfl)
    for _ in range(20):
        arrival = rng.lognormal(0.0, 1.0, 15).astype(np.float32)
        dropped = rng.random(15) < 0.3
        a = mine.select(arrival, dropped, fl, 10)
        b = theirs.select(arrival, dropped, jfl, 10)
        for f in ("mask", "staleness", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.round_time, a.n_arrived) == (b.round_time, b.n_arrived)


# --------------------------------------------------------------------------
# the chaos layer's streams
# --------------------------------------------------------------------------

def test_chaos_draws_deterministic_and_replayable():
    fl = _fl()
    d1, d2 = _data(chaos=CHAOS), _data(chaos=CHAOS)
    out1 = d1.round_chunk(3, 4, fl.local_steps, fl.local_batch,
                          participation=_full_sync(fl))
    out2 = d2.round_chunk(3, 4, fl.local_steps, fl.local_batch,
                          participation=_full_sync(fl))
    for a, b in zip(jax.tree.leaves(out1), jax.tree.leaves(out2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    part = out1[3]
    assert part["mask"].shape == (3, 4) and part["round_time"].shape == (3,)
    assert part["n_arrived"].dtype == np.int32

    # skip_round_sampling replays the chaos draws too: a fresh dataset
    # skipped past 2 rounds produces round 3 exactly
    d3 = _data(chaos=CHAOS)
    d3.skip_round_sampling(2, 4, fl.local_steps, fl.local_batch)
    tail = d3.round_chunk(1, 4, fl.local_steps, fl.local_batch,
                          participation=_full_sync(fl))
    np.testing.assert_array_equal(tail[0][0], out1[0][2])       # cids
    np.testing.assert_array_equal(tail[3]["mask"][0], part["mask"][2])
    np.testing.assert_array_equal(tail[3]["round_time"][0],
                                  part["round_time"][2])


def test_chaos_streams_equal_jax_draw_for_draw():
    """The static speeds, every round's cohort, batches, chaos draws and
    participation outcome equal the JAX package's, also after a
    ``skip_round_sampling`` replay."""
    fl = _fl()
    policy = DeadlinePolicy()
    jpolicy = jpart.DeadlinePolicy()
    mine = _data(chaos=CHAOS)
    theirs = _data(chaos=JChaos(**CHAOS_KW), cls=JFD)
    np.testing.assert_array_equal(mine._client_speed, theirs._client_speed)

    def sel(p, fl_):
        return lambda d: p.select(d.arrival, d.dropped, fl_, 4)

    for dataset in (mine, theirs):
        dataset.skip_round_sampling(2, 6, fl.local_steps, fl.local_batch)
    a = mine.round_chunk(3, 6, fl.local_steps, fl.local_batch,
                         participation=sel(policy, fl))
    b = theirs.round_chunk(3, 6, fl.local_steps, fl.local_batch,
                           participation=sel(jpolicy, _fl(JFL)))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert sorted(a[3]) == sorted(b[3])


def test_chaos_stream_independent_of_reader():
    """Chaos draws are consumed iff chaos is configured, whoever reads
    them, so the batch stream is a pure function of (seed, chaos on?,
    round)."""
    fl = _fl()
    a = _data(chaos=CHAOS).round_chunk(2, 4, fl.local_steps, fl.local_batch,
                                       participation=_full_sync(fl))
    b = _data(chaos=CHAOS).round_chunk(2, 4, fl.local_steps, fl.local_batch)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])


def test_chaos_off_consumes_nothing():
    """A chaos-less dataset's rng stream is untouched by the chaos hooks:
    the precondition for every existing run staying bit for bit."""
    fl = _fl()
    a = _data().round_chunk(2, 4, fl.local_steps, fl.local_batch)
    b = _data().round_chunk(2, 4, fl.local_steps, fl.local_batch,
                            participation=_full_sync(fl))
    np.testing.assert_array_equal(a[0], b[0])
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
    assert b[3]["mask"].min() == 1.0 and b[3]["weight"].min() == 1.0


def test_sample_clients_overdraw_raises_participation_hint():
    with pytest.raises(ValueError, match="over_provision"):
        _data().sample_clients(100)


# --------------------------------------------------------------------------
# the engine: off is today's path, on is chunk- and resume-invariant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
@pytest.mark.parametrize("codec", ["identity", "topk"])
def test_chaos_off_full_sync_bitwise(tmp_path, mode, codec):
    """The default config (full_sync, no chaos) is the engine without
    participation: model, CommLog history and the checkpointed EF state
    equal the reference loop's exactly, and no participation input
    exists."""
    fl = _fl(uplink_codec=codec, topk_frac=0.1, participation="full_sync")
    kw = dict(rounds=4, mode=mode, **RUN)
    eng = run_federated(_bundle(), fl, _data(), superstep_rounds=2,
                        checkpoint_dir=str(tmp_path / "eng"), **kw)
    ref = run_federated_reference(_bundle(), fl, _data(),
                                  checkpoint_dir=str(tmp_path / "ref"), **kw)
    _same_state(ref, eng)
    assert ref.comm.history == eng.comm.history
    assert ref.comm.bytes_up == eng.comm.bytes_up
    assert eng.stats["participation"] is None
    assert eng.stats["round_cohort"] == 4
    assert all("sim_time" not in h for h in eng.comm.history)
    for fname in (("state.npz", "ef.npz") if codec == "topk"
                  else ("state.npz",)):
        a = np.load(tmp_path / "eng" / fname)
        b = np.load(tmp_path / "ref" / fname)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("policy", ["deadline", "buffered_async"])
@pytest.mark.parametrize("codec", ["identity", "topk"])
def test_participation_chunk_invariant(policy, codec):
    """Participation runs do not depend on the chunk size (the fault
    schedule is host-side and the masking weight-borne)."""
    fl = _fl(participation=policy, over_provision=1.5, buffer_k=2,
             uplink_codec=codec, topk_frac=0.1)
    r1 = run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=4,
                       superstep_rounds=1, **RUN)
    r4 = run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=4,
                       superstep_rounds=4, **RUN)
    _same_state(r1, r4)
    assert r1.comm.history == r4.comm.history
    assert r1.stats["participation"] == policy


def test_participation_paged_ef_equals_dense():
    """The cohort-paged EF store under ``deadline`` (masked rows paged out
    and back unchanged) equals the dense table exactly."""
    fl = _fl(participation="deadline", uplink_codec="topk", topk_frac=0.1)
    kw = dict(rounds=6, superstep_rounds=2, **RUN)
    dense = run_federated(_bundle(), fl, _data(chaos=CHAOS),
                          ef_store="device", **kw)
    paged = run_federated(_bundle(), fl, _data(chaos=CHAOS),
                          ef_store="host", **kw)
    assert paged.stats["ef_store"] == "host"
    _same_state(dense, paged)
    assert dense.comm.history == paged.comm.history


def test_chaos_resume_identical_fault_schedule(tmp_path):
    """Interrupt + resume replays the same fault schedule: the resumed
    run's per-round sim_time / arrived and the final model equal an
    uninterrupted run's."""
    fl = _fl(participation="deadline", over_provision=1.5,
             uplink_codec="topk", topk_frac=0.1)
    kw = dict(superstep_rounds=2, **RUN)
    full = run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=6, **kw)
    run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=2,
                  checkpoint_dir=str(tmp_path), checkpoint_every=2, **kw)
    resumed = run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=6,
                            checkpoint_dir=str(tmp_path), checkpoint_every=2,
                            **kw)
    _same_state(full, resumed)
    tail = [(h["sim_time"], h["arrived"]) for h in full.comm.history][2:]
    assert tail == [(h["sim_time"], h["arrived"])
                    for h in resumed.comm.history]


def test_chaos_partial_uplink_accounting():
    """Dropped clients never upload: bytes_up charges the n_arrived
    clients, the downlink the whole (over-provisioned) cohort."""
    fl = _fl(participation="deadline", over_provision=1.5)
    res = run_federated(_bundle(), fl, _data(chaos=CHAOS), rounds=4,
                        superstep_rounds=2, **RUN)
    assert res.stats["round_cohort"] == 6
    model_b = res.comm._model_b
    assert all(1 <= h["arrived"] <= 4 for h in res.comm.history)
    for h in res.comm.history:
        assert h["bytes_up"] == int(h["arrived"]) * model_b
        assert h["bytes_down"] == 6 * model_b
        assert h["bytes_up_ideal"] == 6 * model_b
        assert h["sim_time"] > 0


def test_participation_ef_preserved_for_masked_clients():
    """A masked (dropped / late) client's EF residual comes back bit for
    bit: its update never reached the server."""
    bundle = _bundle()
    fl = _fl(uplink_codec="topk", topk_frac=0.1)
    uplink = make_codec("topk", topk_frac=0.1)
    downlink = make_codec("identity")
    state = init_global_state(bundle, fl, torch.Generator().manual_seed(0),
                              device="cpu")
    uplink.bind(state["model"])
    downlink.bind(state["model"])
    gen = torch.Generator().manual_seed(0)
    C, S, B = 4, fl.local_steps, fl.local_batch
    batches = {"x": torch.randn(C, S, B, 8, 8, 1, generator=gen),
               "y": torch.randint(0, 4, (C, S, B), generator=gen)}
    ef = [0.1 * torch.randn((C,) + tuple(z.shape), generator=gen)
          for z in uplink.init_state()]
    pmask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    round_fn = make_compressed_round_fn(bundle, fl, "client_parallel",
                                        uplink, downlink)
    _, metrics, new_ef, _ = round_fn(
        state, batches, torch.full((C,), float(B * S)) * pmask, 0.05, ef,
        state["model"], (None, None), pmask, torch.zeros(C))
    for old, new in zip(ef, new_ef):
        assert torch.equal(old[1], new[1]) and torch.equal(old[3], new[3])
        assert not torch.equal(old[0], new[0])
        assert not torch.equal(old[2], new[2])
    assert torch.isfinite(metrics["local_loss"])


def test_reference_loop_refuses_chaos():
    with pytest.raises(NotImplementedError, match="engine feature"):
        run_federated_reference(_bundle(), _fl(), _data(chaos=CHAOS),
                                rounds=1, device="cpu")
    with pytest.raises(NotImplementedError, match="engine feature"):
        run_federated_reference(_bundle(), _fl(participation="deadline"),
                                _data(), rounds=1, device="cpu")


# --------------------------------------------------------------------------
# against the JAX package's engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy,codec,mode", [
    ("deadline", "topk", "client_parallel"),
    ("buffered_async", "identity", "client_parallel"),
    ("buffered_async", "topk", "client_sequential")])
def test_participation_matches_jax(policy, codec, mode):
    kw = dict(participation=policy, over_provision=1.5, buffer_k=2,
              uplink_codec=codec, topk_frac=0.1)
    jb = j_make_bundle(dataclasses.replace(CNN_CONFIGS["cnn_mnist"],
                                           **NARROW))
    jfl = _fl(JFL, **kw)
    jres = j_run_federated(jb, jfl, _data(chaos=JChaos(**CHAOS_KW), cls=JFD),
                           rounds=4, seed=1, eval_every=2, mode=mode,
                           superstep_rounds=2)
    s0 = jax.tree.map(np.asarray,
                      j_init_global_state(jb, jfl, jax.random.PRNGKey(1)))
    tres = run_federated(_bundle(), _fl(**kw), _data(chaos=CHAOS), rounds=4,
                         superstep_rounds=2, mode=mode,
                         global_state=state_from_numpy(s0), **RUN)
    assert tres.stats["participation"] == policy
    assert len(tres.comm.history) == len(jres.comm.history) == 4
    exact = ("round", "bytes_up", "bytes_down", "bytes_up_ideal",
             "cum_bytes_up", "sim_time", "arrived")
    for ht, hj in zip(tres.comm.history, jres.comm.history):
        assert set(ht) == set(hj)
        assert {k: ht[k] for k in exact} == {k: hj[k] for k in exact}
        for k in ("local_loss", "loss"):
            if k in hj:
                np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4,
                                           atol=1e-5)
    assert tres.comm.bytes_up == jres.comm.bytes_up
    got = state_to_numpy(tres.global_state)
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jres.global_state))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
