"""``python -m repro_torch.analysis``: run the invariant passes, emit JSON
(port of ``repro/analysis/cli.py``).

The sharded half of the matrix needs a process group of ranks.  The JAX
CLI respawns itself under forced host devices; this one spawns
``--devices`` ranks of itself (``--rank`` / ``--world-size`` /
``--init-file``, a ``file://`` rendezvous in a temporary directory):
gloo on the CPU, NCCL on the card (one card a rank).  A host with one
card runs the sharded points in this process over a one-rank NCCL group.
Each rank writes its report; the parent merges them into its own.

Points run on ``--device`` (the card unless another device is named:
``--device cpu``).  Exit status: 0 clean, 1 findings or per-point errors,
2 usage errors.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import torch

from repro_torch.analysis.lower import default_matrix, default_shard
from repro_torch.analysis.registry import (AnalysisFailure, make_pass,
                                           registered_passes)
from repro_torch.analysis.runner import Report, run_analysis
from repro_torch.device import resolve_device


def _src_env() -> dict:
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env


def _run_sharded_ranks(passes: List[str], preset: str, devices: int,
                       device: torch.device) -> Report:
    """Run the sharded points in ``devices`` spawned ranks; their reports
    merged."""
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        reports = [os.path.join(tmp, f"report.{r}.json")
                   for r in range(devices)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--scope",
             "sharded", "--preset", preset, "--passes", ",".join(passes),
             "--device", device.type, "--rank", str(r), "--world-size",
             str(devices), "--init-file", init, "--report", reports[r],
             "--quiet"], env=_src_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(devices)]
        rep = Report(passes=passes)
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=3600)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if not os.path.exists(reports[r]):
                rep.errors.append({
                    "point": f"<sharded rank {r}>", "pass": "cli",
                    "error": f"exit {p.returncode}; no report written; "
                             f"stderr tail: {err[-2000:]}"})
                continue
            with open(reports[r]) as f:
                child = Report.from_json(json.load(f))
            rep = rep.merged(child)
        rep.elapsed_s = time.perf_counter() - t0     # the ranks ran at once
        return rep


def _sharded(passes: List[str], preset: str, devices: int,
             device: torch.device) -> Report:
    """The sharded points over ``devices`` ranks (on the card at most one a
    card): spawned, or in this process over its process group or a
    one-rank group it opens (NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist
    if device.type == "cuda":
        devices = min(devices, torch.cuda.device_count())
    if devices > 1:
        return _run_sharded_ranks(passes, preset, devices, device)
    specs = default_matrix(preset, sharded=True)
    if dist.is_initialized():
        return run_analysis(specs, passes=passes, device=device)
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/init", rank=0,
                            world_size=1)
    try:
        return run_analysis(specs, passes=passes, device=device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(args, names: List[str], device: torch.device) -> Report:
    """A spawned rank: join the group, run the sharded points, leave."""
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{args.init_file}",
                            rank=args.rank, world_size=args.world_size)
    try:
        return run_analysis(default_matrix(args.preset, sharded=True),
                            passes=names, device=device,
                            shard=default_shard())
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant analyzer for the engine's chunks")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass names (default: all "
                         "registered)")
    ap.add_argument("--preset", default="quick",
                    choices=("quick", "full"),
                    help="config-matrix size (default: quick)")
    ap.add_argument("--scope", default="all",
                    choices=("all", "unsharded", "sharded"),
                    help="restrict to un/sharded matrix points")
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks for the sharded points (default: 2; one "
                         "card a rank on the card, where one card runs "
                         "them in this process)")
    ap.add_argument("--device", default=None,
                    help="device the points run on (default: the card)")
    ap.add_argument("--report", default=None,
                    help="write the JSON report here")
    ap.add_argument("--list-passes", action="store_true",
                    help="list registered passes and exit")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable summary")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.list_passes:
        for name in registered_passes():
            p = make_pass(name)
            print(f"{name:18s} [{p.scope}]"
                  f"{' (capture)' if p.needs_capture else ''} "
                  f"{p.description}")
        return 0

    names = ([n.strip() for n in args.passes.split(",") if n.strip()]
             if args.passes else list(registered_passes()))
    try:
        instances = [make_pass(n) for n in names]
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.devices < 1:
        print("error: --devices must be >= 1", file=sys.stderr)
        return 2
    lowered_names = [p.name for p in instances if p.scope == "lowered"]
    device = resolve_device(args.device) if lowered_names else None

    try:
        if args.rank is not None:
            rep = _rank_main(args, lowered_names, device)
        else:
            rep = Report(passes=names)
            if args.scope != "sharded":
                rep = run_analysis(default_matrix(args.preset,
                                                  sharded=False),
                                   passes=names, device=device)
            if args.scope != "unsharded" and lowered_names:
                rep = rep.merged(_sharded(lowered_names, args.preset,
                                          args.devices, device))
    except AnalysisFailure as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.report:
        d = os.path.dirname(args.report)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(rep.to_json(), f, indent=2, sort_keys=True)

    if not args.quiet:
        print(f"repro_torch.analysis: {len(rep.points)} point(s), passes "
              f"{','.join(rep.passes)}, {rep.elapsed_s:.1f}s")
        for f in rep.findings:
            print(f"FINDING {f}")
        for e in rep.errors:
            print(f"ERROR [{e.get('pass')}] {e.get('point')}: "
                  f"{e.get('error')}")
        print("OK" if rep.ok else
              f"VIOLATIONS: {len(rep.findings)} finding(s), "
              f"{len(rep.errors)} error(s)")
    return 0 if rep.ok else 1
