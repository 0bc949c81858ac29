"""The port's numpy data copy against ``repro.data``: the same images, the
same partitions, and — for one seed — the same cohorts and round batches
draw for draw (exact equality, no tolerance: the numpy streams are one)."""
import numpy as np
import pytest

from repro.data import federated as jfed
from repro.data import partition as jpart
from repro.data.synth import class_images as j_class_images
from repro_torch.data import federated as tfed
from repro_torch.data import partition as tpart
from repro_torch.data.synth import class_images as t_class_images


def _eq(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _images():
    return j_class_images(6, shape=(12, 12, 1), seed=0, template_seed=0)


@pytest.mark.parametrize("kw", [dict(), dict(shape=(32, 32, 3), seed=3,
                                             template_seed=7, noise=0.25)])
def test_class_images_identical(kw):
    a = j_class_images(5, **kw)
    b = t_class_images(5, **kw)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
        assert u.dtype == v.dtype


@pytest.mark.parametrize("name,kw", [
    ("iid_partition", dict(seed=2)),
    ("artificial_noniid_partition", dict(shards_per_client=2, seed=1)),
    ("class_split_partition", dict()),
    ("permuted_partition", dict(seed=4)),
])
def test_partitions_identical(name, kw):
    x, y = _images()
    a = getattr(jpart, name)(x, y, 5, **kw)
    b = getattr(tpart, name)(x, y, 5, **kw)
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        _eq(pa, pb)


def test_round_sampling_identical_for_five_rounds():
    x, y = _images()
    parts = jpart.artificial_noniid_partition(x, y, 6, shards_per_client=2)
    test = {"x": x[:9], "y": y[:9]}
    jd = jfed.FederatedDataset(parts, test, seed=5)
    td = tfed.FederatedDataset(parts, test, seed=5)
    np.testing.assert_array_equal(jd.client_sizes(), td.client_sizes())
    for _ in range(5):
        cj, ct = jd.sample_clients(4), td.sample_clients(4)
        np.testing.assert_array_equal(cj, ct)
        (bj, sj), (bt, st) = jd.round_batch(cj, 3, 4), td.round_batch(ct, 3, 4)
        _eq(bj, bt)
        np.testing.assert_array_equal(sj, st)
        assert bt["x"].shape == (4, 3, 4, 12, 12, 1)
    _eq(jd.test_batch(), td.test_batch())
    _eq(jd.test_batch(5), td.test_batch(5))


def test_skip_round_sampling_replays_the_stream():
    x, y = _images()
    parts = jpart.iid_partition(x, y, 6)
    jd = jfed.FederatedDataset(parts, {"x": x, "y": y}, seed=2)
    td = tfed.FederatedDataset(parts, {"x": x, "y": y}, seed=2)
    for d in (jd, td):
        d.sample_clients(3)
        d.skip_round_sampling(2, 3, 2, 4)
    cj, ct = jd.sample_clients(3), td.sample_clients(3)
    np.testing.assert_array_equal(cj, ct)
    _eq(jd.round_batch(cj, 2, 4)[0], td.round_batch(ct, 2, 4)[0])


def test_floyd_sampling_identical_above_threshold():
    n = tfed._FLOYD_THRESHOLD + 50
    assert n > jfed._FLOYD_THRESHOLD
    shard = {"x": np.zeros((3, 2, 2, 1), np.float32),
             "y": np.zeros(3, np.int32)}
    clients = [shard] * n
    jd = jfed.FederatedDataset(clients, shard, seed=9)
    td = tfed.FederatedDataset(clients, shard, seed=9)
    for _ in range(3):
        ct = td.sample_clients(16)
        np.testing.assert_array_equal(jd.sample_clients(16), ct)
        assert len(np.unique(ct)) == 16


def test_sample_clients_refuses_oversized_cohort():
    x, y = _images()
    td = tfed.FederatedDataset(tpart.iid_partition(x, y, 3), {"x": x, "y": y})
    with pytest.raises(ValueError, match="distinct"):
        td.sample_clients(4)
