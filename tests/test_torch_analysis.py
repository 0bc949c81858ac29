"""repro_torch.analysis on the CPU: the pass registry, the config matrix
and wire model against the JAX analyzer's, the unsharded quick points
clean through the CLI, seeded violations each caught by its pass (the
float64 leaf included, which the JAX pass misses), and the source lint
against the JAX lint on a planted tree.

Sharded points run over spawned gloo ranks in
``tests/test_torch_analysis_sharded.py``; a point captured on the card in
``tests/test_torch_cuda.py``.  Every comparison here is exact.
"""
import json

import pytest
import torch
import torch.distributed

from repro.analysis.lint import SourceLintPass as JSourceLintPass
from repro.analysis import SuperstepSpec as JSpec
from repro.analysis import default_matrix as j_default_matrix
from repro.analysis import lower_superstep as j_lower_superstep
from repro.analysis import registered_passes as j_registered_passes
from repro_torch.analysis import (AnalysisPass, Finding, SuperstepSpec,
                                  default_matrix, lower_superstep, make_pass,
                                  register_pass, registered_passes)
from repro_torch.analysis import cli
from repro_torch.analysis import lint
from repro_torch.analysis import registry as _registry
from repro_torch.engine import engine as t_engine
from repro_torch.tree import tree_leaves

BUILTIN_PASSES = ("collective-bytes", "collectives", "donation", "dtype",
                  "host-sync", "source-lint")
UNSHARDED_QUICK = [s.point for s in default_matrix("quick", sharded=False)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lower_wrapped(inner_wrap=None, **kw):
    """A point lowered on the CPU at 1 and 2 rounds (the cheapest K that
    still tells a round from the chunk around it)."""
    return lower_superstep(SuperstepSpec(n_rounds=1, **kw), device="cpu",
                           inner_wrap=inner_wrap)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_builtin_passes_registered_as_in_jax():
    assert registered_passes() == BUILTIN_PASSES == j_registered_passes()
    for name in BUILTIN_PASSES:
        p = make_pass(name)
        assert p.name == name
        assert p.scope in ("lowered", "source")
        assert p.description


def test_registry_round_trip_and_validation():
    @register_pass
    class _TmpPass(AnalysisPass):
        name = "tmp-test-pass"
        scope = "source"

        def run(self, target):
            return [self.finding("x", "y")]

    try:
        assert "tmp-test-pass" in registered_passes()
        f = make_pass("tmp-test-pass").run(None)[0]
        assert isinstance(f, Finding) and f.pass_name == "tmp-test-pass"
    finally:
        _registry._PASSES.pop("tmp-test-pass")

    with pytest.raises(KeyError):
        make_pass("no-such-pass")
    with pytest.raises(ValueError, match="non-empty"):
        register_pass(type("Nameless", (AnalysisPass,), {}))
    with pytest.raises(ValueError, match="scope"):
        register_pass(type("BadScope", (AnalysisPass,),
                           {"name": "bad-scope", "scope": "nope"}))
    with pytest.raises(ValueError, match="already registered"):
        register_pass(type("Dup", (AnalysisPass,),
                           {"name": "collectives", "scope": "lowered"}))
    with pytest.raises(TypeError):
        register_pass(object)


# ---------------------------------------------------------------------------
# The matrix and the wire model, against the JAX analyzer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharded", [None, True, False])
@pytest.mark.parametrize("preset", ["quick", "full"])
def test_default_matrix_ids_equal_jax(preset, sharded):
    got = [s.point for s in default_matrix(preset, sharded=sharded)]
    want = [s.point for s in j_default_matrix(preset, sharded=sharded)]
    assert got == want
    assert len(set(got)) == len(got)


@pytest.mark.parametrize("codec,controller", [
    ("plain", "static"), ("topk", "static"), ("int8", "static"),
    ("quant+downtopk", "static"), ("fusion-topk", "static"),
    ("topk", "ef_ratio"), ("int8", "bytes_budget")])
def test_wire_model_equals_jax(codec, controller):
    low = lower_wrapped(codec=codec, controller=controller)
    want = j_lower_superstep(JSpec(codec=codec, controller=controller,
                                   n_rounds=1))
    assert low.ideal_model_bytes == want.ideal_model_bytes
    assert low.wire_up == want.wire_up
    assert low.wire_down == want.wire_down
    assert low.level_bytes == want.level_bytes
    if controller != "static":
        assert low.level_bytes is not None
    assert low.cohort == want.cohort


# ---------------------------------------------------------------------------
# The CLI and the unsharded quick points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quick_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("analysis") / "report.json"
    rc = cli.main(["--scope", "unsharded", "--device", "cpu", "--report",
                   str(path), "--quiet"])
    with open(path) as f:
        return rc, json.load(f)


def test_cli_unsharded_on_the_cpu_exits_clean(quick_report):
    rc, rep = quick_report
    assert rc == 0 and rep["ok"], rep
    assert set(rep["points"]) == set(UNSHARDED_QUICK) | {"src/repro_torch"}
    assert rep["passes"] == list(BUILTIN_PASSES)


@pytest.mark.parametrize("point", UNSHARDED_QUICK)
def test_unsharded_quick_point_clean(quick_report, point):
    _, rep = quick_report
    assert sorted(rep["points"][point]) == [
        p for p in BUILTIN_PASSES if p != "source-lint"]
    assert not [f for f in rep["findings"] if f["point"] == point]
    assert not [e for e in rep["errors"] if e["point"] == point]


def test_cli_list_passes_and_usage(capsys):
    assert cli.main(["--list-passes"]) == 0
    out = capsys.readouterr().out
    for name in BUILTIN_PASSES:
        assert name in out
    assert cli.main(["--passes", "no-such-pass", "--device", "cpu"]) == 2


def test_lowering_counts_rounds_and_kernels():
    """The record is of executed ops: a round more is a round's ops more,
    and each EF leaf's K6 / K7 call is one kernel entry."""
    from repro_torch.analysis import kernel_launches
    low = lower_wrapped(codec="topk")
    n_leaves = len(low.model_sizes)
    assert kernel_launches(low.record) == {"ef_gather": n_leaves,
                                           "ef_scatter": n_leaves}
    assert kernel_launches(low.record_next) == {"ef_gather": 2 * n_leaves,
                                                "ef_scatter": 2 * n_leaves}
    assert len(low.record_next) > len(low.record)
    assert low.ef_rows == 8


# ---------------------------------------------------------------------------
# Seeded violations: each must be caught
# ---------------------------------------------------------------------------

def test_mutation_host_sync_caught():
    def add_sync(fn):
        def g(*args, **kw):
            tree_leaves(args[0])[0].sum().item()
            return fn(*args, **kw)
        return g

    low = lower_wrapped(add_sync, codec="topk")
    findings = make_pass("host-sync").run(low)
    assert findings, "host-sync pass missed a planted .item()"
    assert any("_local_scalar_dense" in f.message for f in findings)


def test_mutation_f64_leaf_caught():
    def add_f64(fn):
        def g(*args, **kw):
            out = fn(*args, **kw)
            state = out[0]
            leaf = tree_leaves(state["model"])[0]
            leaf.copy_((leaf.to(torch.float64) * 1.000001).to(leaf.dtype))
            return out
        return g

    low = lower_wrapped(add_f64, codec="topk")
    findings = make_pass("dtype").run(low)
    assert findings, "dtype pass missed a planted float64 value"
    assert any("float64" in f.message for f in findings)


def test_mutation_rebinding_in_place_of_copy_caught(monkeypatch):
    # the chunk body rebinds the new state instead of copying it into the
    # carried buffers: the engine's next chunk would read stale state
    monkeypatch.setattr(t_engine, "_copy_into", lambda dst, src: None)
    low = lower_wrapped(codec="topk")
    findings = make_pass("donation").run(low)
    assert findings, "donation pass missed a dropped in-place update"
    assert any("not written in place" in f.message for f in findings)


def test_mutation_hidden_ef_copy_caught():
    def copy_ef(fn):
        def g(state, ef_all, *args, **kw):
            return fn(state, [t.clone() for t in ef_all], *args, **kw)
        return g

    low = lower_wrapped(copy_ef, codec="topk")
    msgs = [f.message for f in make_pass("donation").run(low)]
    assert any("hidden copy" in m for m in msgs), msgs
    assert any("not written in place" in m for m in msgs), msgs


def test_mutation_fake_wire_model_caught():
    low = lower_wrapped(codec="topk")
    assert not make_pass("collective-bytes").run(low)
    low.wire_up = low.ideal_model_bytes * 2     # codec "expands" the wire
    findings = make_pass("collective-bytes").run(low)
    assert any("above the ideal" in f.message for f in findings)
    low2 = lower_wrapped(codec="topk", controller="ef_ratio")
    assert not make_pass("collective-bytes").run(low2)
    low2.level_bytes = tuple(reversed(low2.level_bytes))
    findings = make_pass("collective-bytes").run(low2)
    assert any("not ascending" in f.message for f in findings)


def test_sharded_point_without_a_group_is_refused(monkeypatch):
    from repro_torch.analysis import AnalysisFailure
    # as in a process without one (a test process may hold a group)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(AnalysisFailure, match="process group"):
        lower_superstep(SuperstepSpec(codec="topk", sharded=True),
                        device="cpu")


# ---------------------------------------------------------------------------
# Source lint
# ---------------------------------------------------------------------------

def test_source_lint_clean_with_an_empty_allowlist():
    assert lint.ALLOWLIST == ()
    assert lint.ALLOWED_LOCAL_IMPORT_ROOTS == ("repro_torch", "torch")
    assert make_pass("source-lint").run(None) == []


PLANTED = {
    "mod.py": "def f(x):\n    assert x\n    import os\n    return os.sep\n",
    "core/branch.py": ("def g(fl):\n    if fl.algorithm == 'fedavg':\n"
                       "        return 1\n"
                       "    return fl.algorithm in ('fedmmd', 'fedl2')\n"),
    "fl/api/plugin.py": ("def h(fl):\n    return fl.algorithm == 'fedavg'"
                         "\n"),
    "ok.py": ("import os\n\n\ndef k(algorithm, names):\n"
              "    return algorithm in names\n"),
}


def test_source_lint_findings_equal_jax_on_a_planted_tree(tmp_path):
    for rel, text in PLANTED.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    got = [(f.pass_name, f.point)
           for f in lint.SourceLintPass(root=str(tmp_path)).run(None)]
    want = [(f.pass_name, f.point)
            for f in JSourceLintPass(root=str(tmp_path)).run(None)]
    assert got == want
    assert sorted(p for _, p in got) == ["core/branch.py:2",
                                         "core/branch.py:4", "mod.py:2",
                                         "mod.py:3"]
