"""repro_torch.analysis's sharded points on the CPU: one spawn of two
gloo ranks (``tests/_torch_analysis_worker.py``) runs every pass over the
quick preset's sharded points (the fused one-all-reduce layout with each
codec, the unfused oracle, telemetry, participation, a controller, the
paged EF store, everything on), and an all-reduce planted outside the
point's ``ClientSharding``, which the collective passes must catch.
Counts are exact."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import default_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 2
SHARDED_QUICK = [s.point for s in default_matrix("quick", sharded=True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("analysis_sharded")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_analysis_worker.py"),
         str(r), str(WORLD), str(tmp / "init"), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, errs[r][-3000:]
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_every_rank_analyzed_every_sharded_point(ranks):
    for r in ranks:
        rep = r["report"]
        assert rep["ok"], rep
        assert set(rep["points"]) == set(SHARDED_QUICK) | {"src/repro_torch"}


@pytest.mark.parametrize("point", SHARDED_QUICK)
def test_sharded_quick_point_clean(ranks, point):
    for r in ranks:
        rep = r["report"]
        assert point in rep["points"]
        assert not [f for f in rep["findings"] if f["point"] == point]
        assert not [e for e in rep["errors"] if e["point"] == point]


def test_planted_all_reduce_caught(ranks):
    for r in ranks:
        by_pass = {f["pass"] for f in r["planted"]}
        assert by_pass == {"collectives", "collective-bytes"}, r["planted"]
        msgs = " ".join(f["message"] for f in r["planted"])
        assert "outside its rounds" in msgs
        assert "bypassed" in msgs
