"""The port's cohort-paged EF store (``repro_torch.engine.efstore``) on the
CPU: its plans against the JAX package's on the same inputs (equal), its
host store against JAX's, and the paged engine against the dense one
(exactly equal: page rows hold the dense rows' values), across
checkpoints."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_rounds import NARROW, _data

import repro_torch.engine.engine as t_engine
from repro.engine.efstore import HostEFStore as JStore
from repro.engine.efstore import _patch_map as j_patch_map
from repro.engine.efstore import plan_chunk_static as j_plan
from repro_torch.configs import CNN_MNIST, FLConfig
from repro_torch.data import FederatedDataset
from repro_torch.engine.efstore import HostEFStore, _patch_map
from repro_torch.engine.efstore import plan_chunk_static
from repro_torch.engine.pipeline import HostPrefetcher, WritebackLane
from repro_torch.fl.server import run_federated
from repro_torch.models import make_bundle
from repro_torch.tree import tree_leaves

PLAN_FIELDS = ("vcids", "uniq", "slots", "rows")


def _cids(seed, k, c, n=50):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, c, replace=False) for _ in range(k)])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed,k,c", [(0, 1, 2), (1, 4, 3), (2, 8, 10),
                                      (3, 6, 5)])
def test_plan_matches_jax(seed, k, c, n_shards):
    """On one device and on a mesh (a client's slot on rank cid % S, each
    rank's block followed by its scratch row)."""
    cids = _cids(seed, k, c, n=12)          # small federation: repeats
    got = plan_chunk_static(cids, n_shards, index=seed)
    want = j_plan(cids, n_shards, index=seed)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.p_loc, got.page_rows, got.n_shards, got.index) == \
        (want.p_loc, want.page_rows, want.n_shards, want.index)


@pytest.mark.parametrize("seeds,k", [((0, 1), 4), ((2, 3), 2), ((4, 4), 3),
                                     ((5, 6), 8)])
def test_patch_map_matches_jax(seeds, k):
    prev_c, cur_c = (_cids(s, k, 3, n=10) for s in seeds)
    got = _patch_map(plan_chunk_static(prev_c, index=0),
                     plan_chunk_static(cur_c, index=1))
    want = j_patch_map(j_plan(prev_c, index=0), j_plan(cur_c, index=1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_host_store_matches_jax_store():
    """Same updates and gathers through both stores (the JAX store keys
    its leaves by a pytree, the port's by position)."""
    rng = np.random.default_rng(7)
    shapes = [(4,), (3, 2)]
    t = HostEFStore([torch.zeros(s) for s in shapes])
    j = JStore([np.zeros(s, np.float32) for s in shapes])
    assert t.row_nbytes() == j.row_nbytes() == (4 + 6) * 4
    bufs = [rng.normal(size=(3,) + s).astype(np.float32) for s in shapes]
    for store in (t, j):
        store.update([7, 2, 30], bufs, [0, 1, 2])
    bufs[0][0] = -1.0                      # the stores hold copies
    outs = []
    for store in (t, j):
        out = [np.zeros((4,) + s, np.float32) for s in shapes]
        store.gather([30, 5, 7, 2], out, [0, 1, 2, 3])
        outs.append(out)
        assert (store.hits, store.misses, store.writeback_rows) == (3, 1, 3)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    dense = t.to_dense(40)
    for a, b in zip(dense, j.to_dense(40)):
        np.testing.assert_array_equal(a, b)
    back = HostEFStore([torch.zeros(s) for s in shapes])
    back.from_dense([torch.from_numpy(d) for d in dense])
    assert back.n_rows == 3                # zero rows are absent rows
    for a, b in zip(back.to_dense(40), dense):
        np.testing.assert_array_equal(a, b)


def test_writeback_lane_orders_and_surfaces_errors():
    lane = WritebackLane(name="t-lane")
    seen = []
    for i in range(5):
        lane.submit(lambda i=i: seen.append(i))
    assert lane.wait_done(3)
    lane.flush()
    assert seen == [0, 1, 2, 3, 4]
    lane.submit(lambda: (_ for _ in ()).throw(RuntimeError("disk full")))
    with pytest.raises(RuntimeError, match="disk full"):
        lane.flush()
    lane.submit(lambda: seen.append(5))
    lane.close()                           # runs what is queued, then joins
    assert seen[-1] == 5 and not lane.wait_done(99)


@pytest.mark.parametrize("enabled", [True, False])
def test_prefetcher_yields_in_order_and_reraises(enabled):
    def build(r0, r1):
        if r0 == 4:
            raise ValueError("bad chunk")
        return r1 - r0

    pre = HostPrefetcher(build, [(0, 2), (2, 4), (4, 5)], enabled=enabled)
    got = []
    with pytest.raises(ValueError, match="bad chunk"):
        for item in pre:
            got.append(item)
    pre.close()
    assert got == [(0, 2, 2), (2, 4, 2)]


# --------------------------------------------------------------------------
# the paged engine against the dense one: exact
# --------------------------------------------------------------------------

@functools.cache
def _bundle():
    return make_bundle(dataclasses.replace(CNN_MNIST, **NARROW))


def _data4():
    parts, test = _data(NARROW["input_shape"], 4, 40)
    return FederatedDataset(parts, test, seed=0)


def _run(store, mode="client_parallel", chunk=4, rounds=6, **kw):
    fl = FLConfig(algorithm=kw.pop("algorithm", "fedavg"), fusion_op="conv",
                  clients_per_round=2, local_steps=2, local_batch=8,
                  lr=0.05, uplink_codec="topk", topk_frac=1 / 16)
    return run_federated(_bundle(), fl, _data4(), rounds=rounds, seed=1,
                         mode=mode, eval_examples=64, device="cpu",
                         superstep_rounds=chunk, ef_store=store, **kw)


def _same(a, b):
    for x, y in zip(tree_leaves(a.global_state), tree_leaves(b.global_state)):
        assert torch.equal(x, y)
    assert a.comm.history == b.comm.history


@pytest.mark.parametrize("chunk", [1, 2, 4])
@pytest.mark.parametrize("mode,algorithm", [("client_parallel", "fedavg"),
                                            ("client_sequential",
                                             "fedfusion")])
def test_paged_equals_dense(mode, algorithm, chunk):
    dense = _run("device", mode, chunk, algorithm=algorithm)
    paged = _run("host", mode, chunk, algorithm=algorithm)
    _same(dense, paged)
    assert (dense.stats["ef_store"], paged.stats["ef_store"]) == \
        ("device", "host")
    n_chunks = -(-6 // chunk)
    # every chunk after the first patches its page from the previous one
    assert paged.stats["ef_patched_rows"] > 0 or n_chunks == 1
    # the page holds K*C rows of one client's EF state, whatever N is
    row = sum(t.numel() for t in tree_leaves(
        _bundle().init(torch.Generator()))) * 4
    assert paged.stats["ef_page_bytes"] == min(chunk, 6) * 2 * row
    assert paged.stats["ef_store_rows"] == 4     # every client trained


def test_ef_store_auto_flips_on_projected_bytes(monkeypatch):
    assert _run("auto", rounds=1).stats["ef_store"] == "device"
    monkeypatch.setattr(t_engine, "_EF_STORE_AUTO_BYTES", 1024)
    assert _run("auto", rounds=1).stats["ef_store"] == "host"


def test_paged_ef_npz_equals_dense_ef_npz(tmp_path):
    _run("device", rounds=3, checkpoint_dir=str(tmp_path / "d"))
    _run("host", rounds=3, checkpoint_dir=str(tmp_path / "h"))
    with np.load(tmp_path / "d" / "ef.npz") as d, \
            np.load(tmp_path / "h" / "ef.npz") as h:
        assert d.files == h.files
        for k in d.files:
            np.testing.assert_array_equal(d[k], h[k])
        assert d["#0/#0"].shape[0] == 4          # the compact [N, n] layout
