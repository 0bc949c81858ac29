"""repro_torch.roofline (the cost model over op records and the three-term
roofline) and repro_torch.launch.dryrun on the CPU: an mm's and a conv's
FLOPs against the JAX package's HLO analyzer on the same op compiled on
the CPU, a K-round loop counted K times, collective bytes by kind over a
fake process group, a kernel call costed alike on the CPU and on
``meta``, ``active_param_count`` / ``model_flops`` against the JAX
package's on every architecture, shape and production mesh, the roofline
terms, and one dry-run point's persistent bytes against the JAX layout's.
Every comparison is exact."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_CONFIGS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.launch import sharding as j_sh
from repro.models import transformer as j_tfm
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.hlo import analyze_entry
from repro_torch.analysis.records import OpRecorder, kernel_launches
from repro_torch.configs import ARCH_CONFIGS, INPUT_SHAPES
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MeshSpec
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS, Roofline,
                                  analyze_record, collective_summary,
                                  flops_breakdown, model_flops)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = ((16, 16), (2, 16, 16))


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def record(fn, *args):
    with OpRecorder() as rec:
        fn(*args)
    return rec.record


def test_mm_flops_equal_jax_hlo():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 20)).astype(np.float32)
    b = rng.standard_normal((20, 7)).astype(np.float32)
    want = analyze_entry(jax.jit(jnp.dot).lower(a, b).compile().as_text())
    got = analyze_record(record(torch.mm, torch.from_numpy(a),
                                torch.from_numpy(b)))
    assert got.flops == want.flops == 2 * 12 * 7 * 20
    assert got.bytes == 4 * (12 * 20 + 20 * 7 + 12 * 7)
    rec = record(lambda: torch.mm(torch.from_numpy(a), torch.from_numpy(b))
                 .relu())
    assert [n for n, _, _ in flops_breakdown(rec)] == ["aten.mm",
                                                       "aten.relu"]


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_flops_equal_jax_hlo(padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)

    def jconv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = analyze_entry(jax.jit(jconv).lower(x, w).compile().as_text())
    got = analyze_record(record(
        lambda x, w: F.conv2d(x, w, padding=1 if padding == "SAME" else 0),
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1)))
    assert got.flops == want.flops > 0


def test_conv_backward_counts_each_gradient_it_computes():
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    fwd = 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)
    rec = record(lambda: F.conv2d(x, w, padding=1).sum().backward())
    bwd = [e for e in rec if e.name == "aten.convolution_backward"]
    assert len(bwd) == 1
    # grad_input: each input element feeds C_out x the 3x3 window
    assert analyze_record(bwd).flops == fwd + 2 * (2 * 3 * 8 * 8) * 4 * 9


@pytest.mark.parametrize("K", [1, 3])
def test_a_k_round_loop_counts_k_times(K):
    a, b = torch.randn(6, 5), torch.randn(5, 4)

    def loop():
        y = a
        for _ in range(K):
            y = (y @ b) @ b.t()
        return y

    one = analyze_record(record(lambda: (a @ b) @ b.t()))
    got = analyze_record(record(loop))
    assert got.flops == K * one.flops
    assert got.bytes == K * one.bytes


FAKE_GROUP_COLLECTIVES = """
import json
import torch
import torch.distributed as dist
from repro_torch.analysis.records import OpRecorder
from repro_torch.launch.dryrun import fake_group
from repro_torch.roofline import analyze_record, collective_summary
with fake_group(4):
    t = torch.empty(4, device="meta")
    with OpRecorder() as rec:
        dist.all_reduce(t)
        dist.all_gather_into_tensor(torch.empty(16, device="meta"), t)
        dist.reduce_scatter_tensor(t, torch.empty(16, device="meta"))
        dist.all_to_all_single(torch.empty(8, device="meta"),
                               torch.empty(8, device="meta"))
        dist.broadcast(t, src=0)
        dist.all_reduce(torch.empty(3, dtype=torch.float64, device="meta"))
print(json.dumps([collective_summary(rec.record),
                  analyze_record(rec.record).total_coll_bytes]))
"""


def test_collective_bytes_by_kind_over_a_fake_group():
    # its own process: the fake group is a default process group, and a
    # test process may hold one already
    out = subprocess.run([sys.executable, "-c", FAKE_GROUP_COLLECTIVES],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    summary, total = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary == {
        "all-reduce": [2, 16 + 24], "all-gather": [1, 16],
        "reduce-scatter": [1, 64], "all-to-all": [1, 32],
        "broadcast": [1, 16]}
    assert total == 40 + 16 + 64 + 32 + 16


@pytest.mark.parametrize("kernel", ["ef_gather", "ef_scatter",
                                    "fusion_conv", "topk_select"])
def test_a_kernel_call_costs_the_same_on_cpu_and_meta(kernel):
    def call(device):
        g = torch.Generator().manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=g).to(device)

        # the inputs are made outside the recorded call
        idx = torch.tensor([3, 0, 5], dtype=torch.int32, device=device)
        table, rows = randn(8, 40), randn(3, 40)
        f_g, f_l, w, x = (randn(2, 5, 5, 6), randn(2, 5, 5, 6),
                          randn(12, 6), randn(50))
        return {"ef_gather": lambda: ops.ef_gather(table, idx),
                "ef_scatter": lambda: ops.ef_scatter(table, idx, rows),
                "fusion_conv": lambda: ops.fused_fusion_conv(f_g, f_l, w),
                "topk_select": lambda: ops.topk_threshold_select(x, 0.5),
                }[kernel]

    cpu, meta = record(call("cpu")), record(call("meta"))
    assert analyze_record(cpu) == analyze_record(meta)
    kernels = [e for e in cpu if e.is_kernel]
    assert [e.name for e in kernels] == [f"kernel:{kernel}"]
    assert kernel_launches(cpu) == kernel_launches(meta) == {kernel: 1}
    assert analyze_record(kernels).bytes > 0


@pytest.mark.parametrize("name", sorted(ARCH_CONFIGS))
def test_active_param_count_and_model_flops_equal_jax(name):
    cfg, jcfg = ARCH_CONFIGS[name], J_ARCHS[name]
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    for shape in MESHES:
        tm, jm = MeshSpec(shape, _axes(shape)), AbstractMesh(shape,
                                                             _axes(shape))
        for sname in INPUT_SHAPES:
            for two in (True, False):
                assert model_flops(cfg, INPUT_SHAPES[sname], tm, two) == \
                    j_model_flops(jcfg, J_SHAPES[sname], jm, two)


def test_roofline_terms_from_known_inputs():
    r = Roofline(arch="a", shape="s", mesh="m", chips=2,
                 flops_per_chip=PEAK_FLOPS * 0.5,
                 hbm_bytes_per_chip=HBM_BW * 2.0,
                 coll_bytes_per_chip=LINK_BW * 1.0,
                 model_flops=PEAK_FLOPS * 0.5, peak_memory_bytes=3.0)
    assert (r.t_compute, r.t_memory, r.t_collective) == (0.5, 2.0, 1.0)
    assert r.bottleneck == "memory"
    assert r.useful_ratio == 0.5
    assert r.mfu_bound == 0.5 / (2.0 * 2)
    d = r.to_dict()
    assert d["bottleneck"] == "memory" and d["peak_memory_bytes"] == 3.0
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (67e12, 3.35e12, 450e9)


def _jax_block_bytes(tree, shardings, mesh_shape):
    """Bytes of rank 0's float32 blocks of ``tree`` under JAX's specs."""
    sizes = dict(zip(_axes(mesh_shape), mesh_shape))
    total = 0
    specs = [s.spec for s in jax.tree.leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))]
    assert len(specs) == len(jax.tree.leaves(tree))
    for leaf, s in zip(jax.tree.leaves(tree), specs):
        blocks = 1
        for entry in s:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                blocks *= sizes[a]
        total += int(np.prod(leaf.shape)) // blocks * 4
    return total


def test_dryrun_point_runs_and_its_bytes_equal_the_jax_layout():
    code = ("import json\n"
            "from repro_torch.launch.dryrun import run_one\n"
            "r = run_one('smollm-135m', 'decode_32k', False, save=False)\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec
    assert rec["fits_80gb_hbm"] and rec["roofline"]["chips"] == 256
    assert rec["memory"]["temp_size_in_bytes"] > 0

    shape, jm = (16, 16), AbstractMesh((16, 16), _axes((16, 16)))
    jcfg, jshape = J_ARCHS["smollm-135m"], J_SHAPES["decode_32k"]
    params = jax.eval_shape(lambda k: j_tfm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: j_tfm.init_cache(
        jcfg, jshape.global_batch, jshape.seq_len))
    want = (_jax_block_bytes(params, j_sh.param_shardings(
        jm, params, fsdp=False), shape)
            + _jax_block_bytes(cache, j_sh.cache_shardings(jm, cache),
                               shape))
    assert rec["memory"]["persistent_size_in_bytes"] == want
