"""Device-resident federated training engine (port of
``repro/engine/engine.py``).

``run_federated_engine`` trains in K-round chunks instead of one
Python-dispatched round at a time:

* chunk schedule — the round range is cut where the host must see state
  (eval and checkpoint rounds) and otherwise into ``superstep_rounds``
  chunks; with eval every round the evaluator is folded into the chunk,
  so the chunk size survives.  ``superstep_rounds="auto"`` times a 1- and
  an 8-round chunk and picks the size (:func:`_auto_chunk_rounds`); on the
  card the chosen length's calibration graph serves the run and the other
  is freed;
* CUDA graphs — on the card each chunk length is captured once as a
  ``torch.cuda.CUDAGraph`` over the superstep (the counterpart of the JAX
  package's jitted ``lax.scan`` with donated buffers): static input
  buffers (batches, sizes, lrs, cids, noise, the EF page) and the carried
  state (global state, EF table, broadcast mirror, all allocated outside
  the graph and updated in place) keep their addresses, and every chunk
  copies its staged arrays into the static inputs with
  ``copy_(..., non_blocking=True)`` and replays.  A failed capture raises;
  the engine never runs a chunk eagerly on the card.  On the CPU the same
  superstep runs eagerly.  The same holds for an LM bundle, whose chunks
  run the transformer's local steps (flash attention K8a forward, K8b /
  K8c backward) inside the graph.  The run's graphs share one memory pool
  (one local step's activations, not one set per chunk length), and the
  warm-up runs restore the carried state from a host snapshot, so neither
  adds a copy of the model to the card's peak;
* host pipeline — a prefetch thread samples the next chunk's clients and
  batches into pinned staging buffers (``HostPrefetcher``,
  ``StagingPool``) while the current chunk trains, and metrics return
  through ``MetricsPump``, so the host waits for the card only at
  checkpoints, callbacks and the end of the run;
* boundary eval — reads the live state: it is queued on the stream that
  replays the chunks, so it runs before the next replay writes the state
  (the JAX engine's snapshot guards a donated buffer, which has no
  counterpart here);
* partial participation — ``fl.participation`` names a policy of
  ``repro_torch.fl.participation`` and ``data`` may carry a
  :class:`repro_torch.data.federated.ChaosConfig`.  When either departs
  from the default, the engine samples the policy's (possibly
  over-provisioned) cohort ``c_round``, folds the host-decided mask,
  staleness weight and work fraction into the staged example weights
  (``sizes * mask * weight * work`` in float32, in that order), stages
  ``pmask`` / ``pstale`` as chunk inputs (static buffers of the captured
  graph, like the batches), carries masked clients' EF rows forward
  untouched, and logs each round's ``sim_time`` / ``arrived`` and its
  partial uplink (``n_up``) in the CommLog.  A ``full_sync`` run without
  chaos takes the path without any of this: no new inputs, no new graph;
* EF store — ``ef_store="device"`` keeps the dense ``[N, n]`` table on
  the card; ``"host"`` the cohort-paged store
  (``repro_torch.engine.efstore``: only a ``[K*C, n]`` page is on the
  card); ``"auto"`` pages once the dense table would pass
  ``_EF_STORE_AUTO_BYTES``.  ``ef.npz`` keeps the compact ``[N, n]``
  layout either way, so checkpoints resume across stores;
* equivalence — the sampling stream, the learning rates, the noise and
  the per-round math are the reference loop's
  (``repro_torch.fl.server.run_federated_reference``), so the engine's
  final model and ``CommLog`` history equal it;
* observability — ``telemetry`` adds the taps' ``tele/...`` values to
  every round's metrics (``repro_torch.obs.telemetry``; bit-invisible to
  the model); ``runlog`` (a path or a ``RunLog``) records the host's
  spans, events and counters (``run.start``, ``chunk.dispatch``,
  ``eval.dispatch``, ``checkpoint.save``, ``prefetch.stage``, the EF
  pager's spans, ``metrics.nonfinite`` warnings, the end-of-run waits),
  which ``repro_torch.obs.report`` folds into a report; ``profile_dir``
  writes a ``torch.profiler`` trace of the whole run there, one
  ``superstep`` range per chunk; ``halt_on_nonfinite`` drains the metrics
  at every chunk boundary and stops at the first boundary after a
  non-finite value, with a checkpoint marked ``"halted": true``;
* adaptive compression — ``fl.controller`` other than ``"static"`` binds
  the uplink codec's ladder at capacity, forces on the taps the
  controller reads, and carries its state (``repro_torch.control``)
  through every chunk: on the card its 0-d tensors are static buffers of
  the graph, so the level changes between replays of one graph and the
  codecs read it on the device.  Each round's ``tele/level`` sets the
  round's effective uplink bytes and codec fields in the ``CommLog``;
  ``ctrl.npz`` is saved beside ``ef.npz`` and restored on resume;
* mesh — with ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` from
  ``repro_torch.launch.mesh``) whose client axes (``pod`` / ``data``)
  multiply to S > 1, every rank of the mesh runs this same loop in its own
  process (``repro_torch.engine.sharded``): every rank samples the whole
  chunk from the same seeded stream and stages only its positional block
  of clients (batches, sizes, participation, uplink offsets), the EF
  table is row-sharded by client id with one scratch row a rank
  (``[N/S + 1, n]``; the paged store splits its page the same way), the
  round's traffic is ONE all-reduce with ``fused_collective=True`` (the
  default; ``False`` keeps the unfused oracle), and evaluation splits the
  padded test batch over the ranks with a masked-sum all-reduce
  (``sharded_eval=True``; ``False`` evaluates the whole batch on every
  rank).  Rank 0's ``superstep_rounds="auto"`` choice is broadcast;
  checkpoints gather the EF rows to rank 0, which writes every file
  (``ef.npz`` stays the compact ``[N, n]`` layout) while the others wait
  at a barrier; run logs and ``profile_dir`` traces are rank 0's.  The
  results are allclose to the single-device engine (the all-reduce
  changes the summation order), with the same ``CommLog`` bytes.  On the
  card each chunk length's shard-aware superstep is captured as one CUDA
  graph with the NCCL all-reduces inside (the two eager warm-up runs
  create the communicator first).  A mesh whose client axes multiply to
  1 runs the single-device program.

Kernel launch counts: a kernel wrapper's ``launches`` counter ticks when
Python calls it, i.e. during a graph's two warm-up runs and its capture,
never on a replay.  ``stats["graphs"]`` records, per captured chunk
length, the launches one replay makes (counted during capture) and the
number of replays; the kernels a run launched on the device are
``sum(launches_per_replay * (replays + 2))`` over the graphs (the two
warm-up runs execute too), plus the eager launches outside graphs (the
EF pager's patch: one K6 per EF leaf per chunk after the first).
"""
from __future__ import annotations

import contextlib
import copy
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.convert import load_ctrl, load_ef, restore
from repro_torch.checkpoint.io import (ef_disk_layout, insert_scratch_rows,
                                       save_server_state, save_tree)
from repro_torch.compress import make_codec
from repro_torch.configs.base import FLConfig
from repro_torch.control import (LadderSpec, ladder_kind, ladder_values,
                                 make_controller)
from repro_torch.core.rounds import init_global_state
from repro_torch.device import resolve_device
from repro_torch.engine.efstore import EFPager, HostEFStore, plan_chunk_static
from repro_torch.engine.evaljit import make_eval_fn, pad_eval_batch
from repro_torch.engine.sharded import client_sharding
from repro_torch.engine.metrics import MetricsPump
from repro_torch.engine.pipeline import HostPrefetcher, StagingPool
from repro_torch.engine.superstep import (make_compressed_superstep,
                                          make_plain_superstep)
from repro_torch.fl.participation import make_policy
from repro_torch.launch.sharding import (client_block, ef_table_block,
                                         eval_block)
from repro_torch.models.registry import ModelBundle
from repro_torch.obs.runlog import as_runlog
from repro_torch.obs.telemetry import Telemetry, make_telemetry
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ServerResult", "ChunkProgram", "chunk_body", "carried_tensors",
           "load_chunk_inputs", "chunk_schedule", "run_federated_engine"]

_NON_METRIC_KEYS = frozenset(
    ("round", "bytes_up", "bytes_down", "bytes_up_ideal", "cum_bytes_up"))

# adaptive chunk sizing: pick K so the per-chunk dispatch overhead is at
# most this fraction of the chunk's time, within [lo, hi]
_AUTO_TARGET_OVERHEAD = 0.05
_AUTO_BOUNDS = (8, 256)

# ef_store="auto": keep the dense device table while the projected
# [n_clients, n] EF footprint stays under this (1 GiB), page past it
_EF_STORE_AUTO_BYTES = 1 << 30

# staging pools in the ring: the prefetch queue's depth (2), the chunk
# being consumed and the chunk being built, so a pool is always released
# before it is refilled
_STAGING_SLOTS = 4


@dataclass
class ServerResult:
    global_state: Dict
    comm: "repro_torch.fl.comm.CommLog"  # noqa: F821 (lazy import)
    stats: Optional[Dict] = field(default=None, compare=False)


def chunk_schedule(start: int, rounds: int, chunk: int, *,
                   eval_every: Optional[int] = None,
                   ckpt_every: Optional[int] = None,
                   per_round: bool = False) -> List[Tuple[int, int]]:
    """Cut [start, rounds) into chunks.

    Boundaries land where the host must observe state: after round r when
    ``(r+1) % eval_every == 0`` (eval) or ``(r+1) % ckpt_every == 0``
    (checkpoint).  ``per_round=True`` (callback users) gives one-round
    chunks.  Pass ``eval_every=None`` when evaluation is folded into the
    chunk: it then imposes no boundary.
    """
    bounds = []
    r = start
    while r < rounds:
        if per_round:
            end = r + 1
        else:
            end = min(r + max(1, chunk), rounds)
            for every in (eval_every, ckpt_every):
                if every:
                    end = min(end, (r // every + 1) * every)
        bounds.append((r, end))
        r = end
    return bounds


def _calibration_source(data, seed: int):
    """A shallow clone of ``data`` with an independent rng stream, so
    chunk-size calibration never advances the run's sampling stream."""
    clone = copy.copy(data)
    clone._rng = np.random.default_rng(seed ^ 0xCA11B)
    return clone


def _auto_chunk_rounds(timed: Callable[[int], float], *,
                       target=_AUTO_TARGET_OVERHEAD, bounds=_AUTO_BOUNDS):
    """Pick the chunk size from measured dispatch overhead.

    ``timed(K)`` returns the seconds of one K-round chunk (compiled,
    on throwaway state).  With ``t_K ~ overhead + K * per_round`` the 1-
    and 8-round times identify both terms, and K is chosen so overhead
    stays below ``target`` of the chunk.  Results do not depend on K."""
    t1, t8 = timed(1), timed(8)
    per_round = max((t8 - t1) / 7.0, 1e-7)
    overhead = max(t1 - per_round, 0.0)
    lo, hi = bounds
    return int(np.clip(round(overhead / (per_round * target)), lo, hi))


def _mesh_setup(mesh, device, shard=None):
    """``(shard, device, writer)`` of a run on ``mesh``: this rank's
    :class:`ClientSharding` (None off a mesh or on a one-shard mesh, unless
    one is given), the device (the mesh's unless another is named) and
    whether this rank writes files (rank 0)."""
    if shard is not None:
        if mesh is not None:
            raise ValueError("pass mesh or shard, not both")
        return shard, resolve_device(device), shard.position == 0
    if mesh is None:
        return None, resolve_device(device), True
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_device
    mesh_dev = mesh_device(mesh)
    device = mesh_dev if device is None else resolve_device(device)
    if device.type != mesh_dev.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"({mesh.device_type})")
    return client_sharding(mesh), device, dist.get_rank() == 0


def _group_leader(shard) -> int:
    import torch.distributed as dist
    return dist.get_global_rank(shard.group, 0)


def _gather_to_leader(obj, shard):
    """Every rank's ``(position, obj)`` on the client group's first rank,
    sorted by position (None on the other ranks)."""
    import torch.distributed as dist
    leader = _group_leader(shard)
    out = ([None] * shard.n_shards if dist.get_rank() == leader else None)
    dist.gather_object((shard.position, obj), out, dst=leader,
                       group=shard.group)
    return None if out is None else [o for _, o in sorted(out)]


def _broadcast_int(value: int, shard, device) -> int:
    """The client group's first rank's ``value`` on every rank."""
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=_group_leader(shard), group=shard.group)
    return int(t.item())


def _copy_into(dst, src):
    """``dst``'s leaves take ``src``'s values in place, matched by key (a
    converted JAX state orders its dict keys otherwise)."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _kernel_counters():
    from repro_torch.kernels import compress_pack, fusion_conv, mk_mmd
    return {"gram_sum": mk_mmd.gram_sum_cuda,
            "mk_mmd2": mk_mmd.mk_mmd2_cuda,
            "mk_mmd2_grad": mk_mmd.mk_mmd2_grad_cuda,
            "fusion_conv": fusion_conv.fusion_conv_cuda,
            "quant_pack": compress_pack.quant_pack_cuda,
            "quant_unpack": compress_pack.quant_unpack_cuda,
            "topk_select": compress_pack.topk_select_cuda,
            "ef_gather": compress_pack.ef_gather_cuda,
            "ef_scatter": compress_pack.ef_scatter_cuda}


def _launches():
    return {k: fn.launches for k, fn in _kernel_counters().items()}


def _host_snapshot(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``tensors`` (what a throwaway run restores): at LM
    size the carried state, mirror and EF page are gigabytes, and a clone
    on the card would add them to the run's peak."""
    return [t.to("cpu", copy=True) for t in tensors]


def _restore(tensors: List[torch.Tensor], snapshot: List[torch.Tensor]):
    for t, s in zip(tensors, snapshot):
        t.copy_(s)


class _GraphStep:
    """One chunk length on the card: its static inputs and its graph.

    ``body(inputs)`` runs the superstep on the carried state (in place)
    and returns the stacked metrics.  ``carried`` lists every tensor the
    body writes in place; the two warm-up runs restore it afterwards from
    a host snapshot, so capturing never changes the run's state.  ``pool``
    (a ``torch.cuda.graph_pool_handle()``) is the memory pool the run's
    graphs share: they replay one at a time on one stream and keep their
    outputs alive, so a later capture may reuse what an earlier one freed,
    and every chunk length does not hold a local step's activations of its
    own.  ``capture_mode`` (a context manager, e.g. the analyzer's op
    recorder) is entered around the body during the capture only.
    """

    def __init__(self, n_rounds: int, inputs: Dict, body: Callable,
                 carried: List[torch.Tensor], shard=None, pool=None,
                 capture_mode=None):
        self.n_rounds = n_rounds
        self.inputs = inputs
        self.replays = 0
        snapshot = _host_snapshot(carried)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            for _ in range(2):
                body(inputs)
                _restore(carried, snapshot)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        del snapshot
        # the graph's memory: what capture reserves beyond the emptied
        # cache (torch.cuda.graph empties it on entry, too); a capture
        # into a shared pool reserves only what the pool lacked
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        mid = _launches()
        coll0 = shard.collectives if shard is not None else 0
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            with capture_mode or contextlib.nullcontext():
                self.outputs = body(inputs)
            t1 = time.perf_counter()
        # capture_s: the body's ops recorded; instantiate_s: the end of
        # the capture (cudaStreamEndCapture + cudaGraphInstantiate)
        self.capture_s = t1 - t0
        self.instantiate_s = time.perf_counter() - t1
        after = _launches()
        self.pool_bytes = torch.cuda.memory_reserved() - reserved0
        self.launches_per_replay = {k: after[k] - mid[k] for k in after}
        # all-reduces captured in the graph (replayed with it)
        self.collectives_per_replay = (shard.collectives - coll0
                                       if shard is not None else 0)
        self._ptrs = [t.data_ptr() for t in carried + self._input_leaves()]
        self._carried = carried

    def _input_leaves(self):
        return [t for t in tree_leaves(self.inputs) if t is not None]

    def replay(self) -> Dict[str, torch.Tensor]:
        ptrs = [t.data_ptr() for t in self._carried + self._input_leaves()]
        if ptrs != self._ptrs:
            raise RuntimeError("a captured buffer moved: the graph would "
                               "read or write stale memory")
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def stats(self) -> Dict:
        return {"rounds": self.n_rounds, "replays": self.replays,
                "warmup_s": self.warmup_s, "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s,
                "pool_bytes": self.pool_bytes,
                "launches_per_replay": self.launches_per_replay,
                "collectives_per_replay": self.collectives_per_replay}


def _stack_noise(noise_fn, r0: int, r1: int, n_clients: int):
    """The chunk's offsets as (down per leaf [K, n], up per leaf [K, C,
    n]), drawn round by round in ``noise_fn``'s order; None where a
    direction draws nothing."""
    drawn = [noise_fn(r, n_clients) for r in range(r0, r1)]
    down = up = None
    if drawn[0][0] is not None:
        down = [torch.stack([d[i] for d, _ in drawn])
                for i in range(len(drawn[0][0]))]
    if drawn[0][1] is not None:
        up = [torch.stack([torch.stack([c[i] for c in u]) for _, u in drawn])
              for i in range(len(drawn[0][1][0]))]
    return down, up


def _chunk_times(marks, m_end, on_card):
    """[{r0, r1, start_ms, run_ms}] from each chunk's (start, run, done)
    marks, plus the run's end as ``end_ms`` of the last entry."""
    if not marks:
        return []

    def ms(a, b):
        return a.elapsed_time(b) if on_card else 1e3 * (b - a)

    t0 = marks[0][2]
    out = [{"r0": r0, "r1": r1, "start_ms": ms(t0, m0),
            "run_ms": ms(m1, m2)} for r0, r1, m0, m1, m2 in marks]
    out[-1]["end_ms"] = ms(t0, m_end)
    return out


def _steady_rate(chunk_times):
    """Rounds per second from the second chunk's start to the run's end
    (None with fewer than two chunks)."""
    if len(chunk_times) < 2:
        return None
    span = chunk_times[-1]["end_ms"] - chunk_times[1]["start_ms"]
    rounds = chunk_times[-1]["r1"] - chunk_times[1]["r0"]
    return 1e3 * rounds / span if span > 0 else None


@dataclass
class ChunkProgram:
    """What one chunk's body reads and writes: the superstep's inputs
    besides the staged chunk, and the carried state it updates in place.

    ``run_federated_engine`` builds one per run; ``repro_torch.analysis``
    builds one per matrix point, so the analyzer runs the program the
    engine captures (:func:`chunk_body`) on the buffers it carries
    (:func:`carried_tensors`), staged as the engine stages them
    (:func:`load_chunk_inputs`).  ``supersteps`` caches the superstep of
    each chunk length.
    """
    bundle: ModelBundle
    fl: FLConfig
    mode: str
    device: torch.device
    global_state: Dict
    uplink: object = None
    downlink: object = None
    down_mirror: Optional[Dict] = None
    ef_all: Optional[List[torch.Tensor]] = None
    ef_paged: bool = False
    tele: Optional[Telemetry] = None
    controller: object = None
    ctrl_state: Optional[Dict] = None
    shard: object = None
    fused: bool = True
    eval_fn: Optional[Callable] = None
    test_args: Tuple = ()
    part_active: bool = False
    supersteps: Dict[int, Callable] = field(default_factory=dict)

    @property
    def compressed(self) -> bool:
        return self.fl.compressed

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


def chunk_body(prog: ChunkProgram, n_rounds: int) -> Callable:
    """``body(inputs) -> metrics [K]``: the ``n_rounds`` superstep on
    ``prog``'s carried state, written back in place (on a mesh the
    shard-aware superstep, what ``make_sharded_superstep`` builds, at any
    shard count)."""
    if n_rounds not in prog.supersteps:
        sharded = dict(shard=prog.shard, fused=prog.fused) \
            if prog.shard is not None else {}
        if prog.compressed:
            prog.supersteps[n_rounds] = make_compressed_superstep(
                prog.bundle, prog.fl, prog.mode, n_rounds, prog.uplink,
                prog.downlink, eval_fn=prog.eval_fn, telemetry=prog.tele,
                controller=prog.controller, **sharded)
        else:
            prog.supersteps[n_rounds] = make_plain_superstep(
                prog.bundle, prog.fl, prog.mode, n_rounds,
                eval_fn=prog.eval_fn, telemetry=prog.tele, **sharded)
    superstep = prog.supersteps[n_rounds]

    def body(inputs):
        part = inputs.get("part")
        if prog.compressed:
            ef = inputs["ef_page"] if prog.ef_paged else prog.ef_all
            new_state, mstack, _, new_mirror = superstep(
                prog.global_state, ef, prog.down_mirror, inputs["batches"],
                inputs["sizes"], inputs["lrs"], inputs["cids"],
                inputs["noise"], *prog.test_args, part=part,
                ctrl=prog.ctrl_state)
            _copy_into(prog.down_mirror, new_mirror)
        else:
            new_state, mstack = superstep(
                prog.global_state, inputs["batches"], inputs["sizes"],
                inputs["lrs"], *prog.test_args, part=part)
        _copy_into(prog.global_state, new_state)
        return mstack
    return body


def carried_tensors(prog: ChunkProgram, inputs: Dict) -> List[torch.Tensor]:
    """Every tensor the chunk body writes in place: the global state, the
    broadcast mirror, the EF table (or the chunk's page) and the
    controller state."""
    leaves = tree_leaves(prog.global_state)
    if prog.compressed:
        leaves += tree_leaves(prog.down_mirror)
        leaves += inputs["ef_page"] if prog.ef_paged else (prog.ef_all or [])
    if prog.ctrl_state is not None:
        leaves += tree_leaves(prog.ctrl_state)
    return leaves


def load_chunk_inputs(prog: ChunkProgram, n_rounds: int, staged: Dict, noise,
                      cache: Dict) -> Tuple[Dict, Optional["_GraphStep"]]:
    """The chunk's inputs on the device: on the card copied into the chunk
    length's static buffers (those of its graph in ``cache``, or new), on
    the CPU the staged tensors themselves (a paged EF store's page is a
    fresh buffer the caller fills).  Returns (inputs, graph or None)."""
    src = {"batches": staged["batches"], "sizes": staged["sizes"],
           "lrs": staged["lrs"]}
    if prog.part_active:
        src["part"] = staged["part"]
    if prog.compressed:
        src["cids"] = staged["cids"]
        src["noise"] = noise
    paged = prog.compressed and prog.ef_paged
    if not prog.on_card:
        if paged:
            src["ef_page"] = [torch.empty_like(p) for p in staged["ef_page"]]
        return src, None
    step = cache.get(n_rounds)
    if step is None:
        inputs = tree_map(lambda t: None if t is None else
                          torch.empty(t.shape, dtype=t.dtype,
                                      device=prog.device), src)
        if paged:
            inputs["ef_page"] = [torch.zeros(p.shape, device=prog.device)
                                 for p in staged["ef_page"]]
    else:
        inputs = step.inputs
    for d, s in zip(tree_leaves({k: v for k, v in inputs.items()
                                 if k != "ef_page"}),
                    tree_leaves(src)):
        if d is not None:
            d.copy_(s, non_blocking=True)
    return inputs, step


def run_federated_engine(bundle: ModelBundle, fl: FLConfig, data, *,
                         rounds: int, seed: int = 0,
                         mode: str = "client_parallel",
                         eval_every: int = 1, eval_examples: int = 2048,
                         verbose: bool = False,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 10,
                         checkpoint_from_jax: bool = False,
                         callback: Optional[Callable] = None,
                         superstep_rounds=8, prefetch: bool = True,
                         ef_store: str = "auto",
                         mesh=None, fused_collective: bool = True,
                         sharded_eval: bool = True, shard=None,
                         telemetry=False, runlog=None,
                         halt_on_nonfinite: bool = False,
                         profile_dir: Optional[str] = None,
                         global_state=None,
                         noise_fn: Optional[Callable] = None,
                         device=None) -> ServerResult:
    """Engine-backed server loop (see the module docstring) on ``device``
    (the card unless another device is named).

    Same arguments and result as the reference loop, plus
    ``superstep_rounds`` (rounds per chunk, or ``"auto"``), ``prefetch``
    (background staging) and ``ef_store`` (``"device"`` | ``"host"`` |
    ``"auto"``).
    ``checkpoint_from_jax``: ``checkpoint_dir`` holds a checkpoint the JAX
    package wrote; it is converted on resume
    (:mod:`repro_torch.checkpoint.convert`), unless its ``meta.json``
    carries the marker every save of the port writes.
    ``global_state`` (e.g. a converted JAX state) replaces the seeded
    initial state and is copied, never updated in place; ``noise_fn(r,
    n_clients)`` supplies the quant codecs' offsets (default
    ``repro_torch.fl.server.make_noise_source``).  A ``callback(r, state,
    metrics)`` forces one-round chunks; the state it gets is live and
    valid until it returns.

    Partial participation and chaos, telemetry, run logs, profiling,
    ``halt_on_nonfinite`` and the adaptive controllers follow the module
    docstring (``stats["participation"]``, ``stats["round_cohort"]``,
    ``stats["telemetry"]``, ``stats["halted_at"]``, ``stats["controller"]``,
    ``stats["ladder"]``, ``stats["runlog"]``, ``stats["profile"]``).
    ``telemetry``: True (every tap that fits), a list of tap names, or a
    :class:`repro_torch.obs.Telemetry`.  ``mesh`` (a ``DeviceMesh``;
    ``TypeError`` for anything else), ``fused_collective`` and
    ``sharded_eval``: the module docstring's mesh entry
    (``stats["client_shards"]``, ``stats["fused_collective"]``,
    ``stats["sharded_eval"]``, ``stats["collectives"]``: the all-reduces
    this rank issued in Python).  ``shard``: a
    :class:`repro_torch.core.aggregate.ClientSharding` to run the
    shard-aware supersteps over in place of the one ``mesh`` gives; unlike
    a mesh it takes that path at one shard too (how a one-card host runs
    the sharded supersteps, NCCL all-reduces and all).  ``bundle`` may be
    an image classifier or an LM (``loss_kind == "lm"``): token chunks
    stage ``tokens`` / ``labels`` ``[K, C, steps, B, S]`` in the token
    stream's integer dtype, and eval
    is next-token accuracy and cross-entropy over every position of the
    valid test sequences.
    """
    from repro_torch.fl.comm import CommLog
    from repro_torch.fl.server import make_noise_source

    if ef_store not in ("auto", "device", "host"):
        raise ValueError(f"ef_store={ef_store!r} not in "
                         "('auto', 'device', 'host')")
    shard, device, writer = _mesh_setup(mesh, device, shard)
    n_shards = shard.n_shards if shard is not None else 1
    collectives0 = shard.collectives if shard is not None else 0
    on_card = device.type == "cuda"
    n_sampled = min(fl.clients_per_round, data.n_clients)

    # --- participation: who lands in each round, at what weight ----------
    # part_active=False (full_sync, no chaos) is the path without it: no
    # extra round_chunk outputs, no pmask / pstale inputs
    policy = make_policy(fl.participation)
    part_active = (getattr(data, "chaos", None) is not None
                   or policy.name != "full_sync")
    c_round = policy.cohort_size(n_sampled, fl) if part_active else n_sampled
    select_fn = None
    if part_active:
        def select_fn(draws):
            if draws is None:     # chaos off: everyone reports at t=1.0
                arrival = np.ones(c_round, np.float32)
                dropped = np.zeros(c_round, bool)
            else:
                arrival, dropped = draws.arrival, draws.dropped
            return policy.select(arrival, dropped, fl, n_sampled)

    if shard is not None and c_round % n_shards:
        raise ValueError(
            f"round cohort {c_round} (clients_per_round={n_sampled}, "
            f"policy {policy.name!r}) must divide over the mesh's "
            f"{n_shards} client shards {shard.axes}")

    if global_state is None:
        global_state = init_global_state(
            bundle, fl, torch.Generator().manual_seed(seed), device)
    else:   # a private copy: the engine updates its state in place
        global_state = tree_map(
            lambda t: torch.as_tensor(t).to(device, copy=True).contiguous(),
            global_state)
    start_round = 0
    from_jax = False
    if checkpoint_dir and os.path.exists(
            os.path.join(checkpoint_dir, "meta.json")):
        global_state, start_round, from_jax = restore(
            checkpoint_dir, global_state, device,
            from_jax=checkpoint_from_jax)
        # replay the consumed sampling stream: resumed == uninterrupted
        data.skip_round_sampling(start_round, c_round, fl.local_steps,
                                 fl.local_batch)
    lr_at = exp_decay_per_round(fl.lr, fl.lr_decay)
    comm = CommLog().bind_sizes(global_state)
    meta_extra = {"algorithm": fl.algorithm}

    # host span tracing opens early: the EF pager threads its spans through
    # the same sink.  A path here means the engine owns the sink (stream +
    # close).
    # on a mesh, rank 0 alone records
    if not writer:
        runlog = None
    owns_runlog = runlog is not None and not hasattr(runlog, "span")
    rl = as_runlog(runlog)

    # --- wire codecs: EF store (dense table | cohort-paged) + mirror -----
    compressed = fl.compressed
    # adaptive compression controller: "static" is the bitwise oracle (no
    # ladder, no controller state in any chunk)
    ctrl_active = compressed and fl.controller != "static"
    controller = ctrl_spec = ctrl_state = None
    wire_up = wire_down = None
    uplink = downlink = None
    ef_template = ef_all = down_mirror = None
    ef_paged = False
    store = pager = None
    ef_path = None
    if compressed:
        uplink = make_codec(fl.uplink_codec, topk_frac=fl.topk_frac,
                            quant_bits=fl.quant_bits)
        downlink = make_codec(fl.downlink_codec, topk_frac=fl.topk_frac,
                              quant_bits=fl.quant_bits)
        uplink.bind(global_state["model"])
        downlink.bind(global_state["model"])
        wire_up, wire_down = uplink.wire_bytes(), downlink.wire_bytes()
        if ctrl_active:
            # the ladder binds at the codec's capacity (the configured
            # static level, as ladder_values enforces); the device-side
            # level masks the payload down to the effective rung
            ladder = ladder_values(fl)
            uplink.set_ladder(ladder)
            ctrl_spec = LadderSpec(kind=ladder_kind(fl.uplink_codec),
                                   values=ladder,
                                   bytes_up=uplink.level_bytes())
            controller = make_controller(fl.controller).setup(
                ctrl_spec, fl, device)
        ef_template = uplink.init_state()
        store = HostEFStore(ef_template)
        if store.n_leaves == 0:
            ef_paged = False       # stateless uplink: nothing to page
        elif ef_store == "auto":
            ef_paged = (data.n_clients * store.row_nbytes()
                        > _EF_STORE_AUTO_BYTES)
        else:
            ef_paged = ef_store == "host"
        if shard is not None and not ef_paged \
                and data.n_clients % n_shards:
            raise ValueError(
                f"n_clients={data.n_clients} must divide over the mesh's "
                f"{n_shards} client shards (row-sharded EF table); "
                "ef_store='host' lifts the constraint")
        ef_path = (os.path.join(checkpoint_dir, "ef.npz")
                   if checkpoint_dir else None)
        resume_ef = bool(start_round and ef_path and os.path.exists(ef_path))
        ef_like = [None if z is None else
                   torch.empty((data.n_clients,) + tuple(z.shape),
                               device="meta") for z in ef_template]
        if resume_ef:   # ef.npz is the compact [n_clients, ...] layout
            ef_dense, mirror = load_ef(ef_path, ef_like,
                                       global_state["model"], "cpu",
                                       jax=from_jax)
            down_mirror = tree_map(lambda t: t.to(device), mirror)
        else:
            ef_dense = None
            down_mirror = tree_map(torch.clone, global_state["model"])
        if ef_paged:
            pager = EFPager(store, device, shard=shard, runlog=rl)
            if ef_dense is not None:
                store.from_dense(ef_dense, n_shards=n_shards,
                                 position=shard.position if shard else 0)
        elif store.n_leaves and shard is not None:
            # resident scratch-row layout: this rank's [N/S + 1, n] block
            if ef_dense is None:
                ef_dense = [torch.zeros(z.shape) for z in ef_like]
            ef_all = [torch.from_numpy(np.ascontiguousarray(
                ef_table_block(t, shard))).to(device)
                for t in insert_scratch_rows(ef_dense, n_shards)]
        elif store.n_leaves:
            ef_all = ([t.to(device) for t in ef_dense] if ef_dense
                      is not None else
                      [torch.zeros(z.shape, device=device) for z in ef_like])
        if noise_fn is None:
            noise_fn = make_noise_source(uplink, downlink, seed, device)
    uses_noise = compressed and (uplink.uses_noise or downlink.uses_noise)

    # --- telemetry taps ---------------------------------------------------
    # tele=None keeps every round the one without taps, op for op
    tele = None
    if telemetry or ctrl_active:
        if isinstance(telemetry, Telemetry):
            tele = telemetry
        else:
            # a controller's decision signals are telemetry: force its
            # taps (and the schedule-exporting "controller" tap) into the
            # selection even when the caller left telemetry off
            tap_names = (None if telemetry is True
                         else tuple(telemetry) if telemetry else ())
            if ctrl_active and tap_names is not None:
                tap_names = tuple(dict.fromkeys(
                    tap_names + tuple(controller.requires_taps)
                    + ("controller",)))
            tele = make_telemetry(
                "compressed" if compressed else "plain",
                n_clients=c_round, n_shards=n_shards,
                available=frozenset(
                    (("ef",) if compressed and uplink.stateful else ())
                    + (("pmask", "staleness") if part_active else ())
                    + (("level", "eff_bytes") if ctrl_active else ())),
                taps=tap_names)
        if ctrl_active:
            have = {t.name for t in tele.taps} if tele is not None else set()
            missing = [n for n in controller.requires_taps
                       if n not in have]
            if missing:
                raise ValueError(
                    f"controller {fl.controller!r} needs telemetry taps "
                    f"{missing}, unavailable for uplink codec "
                    f"{fl.uplink_codec!r} (e.g. the 'ef' tap needs a "
                    "stateful error-feedback uplink)")

    # controller state: 0-d tensors on the device, carried in place through
    # the chunks; ctrl.npz sits next to ef.npz so a resumed run replays the
    # schedule bit for bit
    ctrl_path = (os.path.join(checkpoint_dir, "ctrl.npz")
                 if checkpoint_dir else None)
    if ctrl_active:
        ctrl_state = controller.init_state()
        if start_round and ctrl_path and os.path.exists(ctrl_path):
            ctrl_state = load_ctrl(ctrl_path, ctrl_state, device)

    def ef_source():
        """The EF backing ``ef_disk_layout`` reads; on a mesh the ranks'
        rows gathered on the group's first rank (None on the others)."""
        if ef_paged:
            pager.flush()
            if shard is None:
                return store
            rows = _gather_to_leader(store.export_rows(), shard)
            if rows is None:
                return None
            merged = HostEFStore(ef_template)
            for r in rows:
                merged.merge_rows(r)
            return merged
        if ef_all is None:
            return ef_template
        if shard is None:
            return ef_all
        blocks = _gather_to_leader([t.cpu().numpy() for t in ef_all], shard)
        if blocks is None:
            return None
        return [np.concatenate(leaf) for leaf in zip(*blocks)]

    def save_checkpoint(r, **extra):
        ef_src = ef_source() if compressed else None
        if writer:
            save_server_state(checkpoint_dir, global_state, r,
                              extra={**meta_extra, **extra}, runlog=rl)
            if compressed:
                n_res = n_shards if ef_all is not None else 1
                save_tree(ef_path, (ef_disk_layout(
                    ef_src, n_shards=n_res, n_clients=data.n_clients),
                    down_mirror), rl)
                if ctrl_active:
                    save_tree(ctrl_path, ctrl_state, rl)
        if shard is not None:
            import torch.distributed as dist
            dist.barrier(group=shard.group)

    # --- fixed-shape evaluation -----------------------------------------
    # on a mesh the eval batch splits positionally over the ranks and the
    # masked metric sums cross one all-reduce; sharded_eval=False
    # evaluates the whole batch on every rank
    test_args = ()
    eval_fn = None
    eval_in_chunk = False
    eval_shard = shard if sharded_eval else None
    if eval_every:
        test_batch, test_mask = eval_block(*pad_eval_batch(
            data.test_batch(), eval_examples, device, shard=eval_shard),
            eval_shard)
        eval_fn = make_eval_fn(bundle, fl, shard=eval_shard)
        eval_in_chunk = eval_every == 1 and callback is None
        if eval_in_chunk:
            test_args = (test_batch, test_mask)

    # --- chunk staging (prefetch thread) ----------------------------------
    pools = ([StagingPool(pin=True) for _ in range(_STAGING_SLOTS)]
             if on_card else None)
    n_built = [0]

    def build_chunk(r0, r1, src=None):
        pool = None
        if pools is not None and src is None:
            pool = pools[n_built[0] % len(pools)]
            n_built[0] += 1
            pool.acquire()
        out = (src or data).round_chunk(
            r1 - r0, c_round, fl.local_steps, fl.local_batch, pool=pool,
            participation=select_fn)
        cids, batches, sizes = out[:3]
        part = out[3] if part_active else None
        if part is not None:
            # the participation outcome is weight-borne: dropped / late
            # clients are zeroed (mask), staleness-discounted (weight) and
            # truncation-scaled (work) here, on the host, in place in the
            # staged (pinned) sizes, in the JAX package's order
            for f in (part["mask"], part["weight"], part["work"]):
                np.multiply(sizes, f, out=sizes)

        def host(name, arr):
            return pool.tensor(name) if pool is not None \
                else torch.from_numpy(arr)

        def mine(name, arr):
            """This rank's positional block of a [K, C, ...] array."""
            return client_block(host(name, arr), shard)

        staged = {"pool": pool,
                  "batches": {k: mine(f"batch/{k}", v)
                              for k, v in batches.items()},
                  "sizes": mine("sizes", sizes),
                  "lrs": torch.tensor([lr_at(r) for r in range(r0, r1)],
                                      dtype=torch.float32)}
        if part is not None:
            staged["part"] = (mine("part/mask", part["mask"]),
                              mine("part/staleness", part["staleness"]))
            # host-only accounting: the simulated round wall-clock and
            # the partial uplink count ride the MetricsPump
            staged["host"] = {
                "metrics": {"sim_time": part["round_time"],
                            "arrived": part["n_arrived"].astype(np.float32)},
                "n_up": part["n_arrived"]}
        if compressed:
            staged["cids"] = host("cids", cids)
            if ef_paged:
                if src is None:
                    plan, page = pager.stage(cids, pool=pool)
                    page = [host(f"ef_page/{i}", p)
                            for i, p in enumerate(page)]
                else:   # calibration: a throwaway zero page
                    plan = plan_chunk_static(cids, n_shards)
                    page = [torch.from_numpy(p)
                            for p in pager.zero_page(plan)]
                staged["cids"] = torch.from_numpy(plan.vcids)
                staged["ef_page"] = page
                staged["ef_plan"] = plan
        return staged

    def draw_noise(r0, r1, fn):
        """The chunk's offsets: drawn for the whole cohort on every rank,
        the uplink's cut to this rank's clients."""
        if not uses_noise:
            return None, None
        down, up = _stack_noise(fn, r0, r1, c_round)
        if up is not None and shard is not None:
            up = [client_block(u, shard) for u in up]
        return down, up

    # --- the chunk body: superstep on the carried state, in place --------
    prog = ChunkProgram(
        bundle=bundle, fl=fl, mode=mode, device=device,
        global_state=global_state, uplink=uplink, downlink=downlink,
        down_mirror=down_mirror, ef_all=ef_all, ef_paged=ef_paged,
        tele=tele, controller=controller, ctrl_state=ctrl_state,
        shard=shard, fused=fused_collective,
        eval_fn=eval_fn if eval_in_chunk else None, test_args=test_args,
        part_active=part_active)
    graphs: Dict[int, _GraphStep] = {}
    graph_pool = torch.cuda.graph_pool_handle() if on_card else None

    def captured(n_rounds, inputs, step, cache=graphs):
        """On the card, the chunk length's graph (captured on first use
        around the loaded inputs, kept in ``cache``); None on the CPU."""
        if on_card and step is None:
            step = cache[n_rounds] = _GraphStep(
                n_rounds, inputs, chunk_body(prog, n_rounds),
                carried_tensors(prog, inputs), shard, graph_pool)
        return step

    def run_chunk(n_rounds, inputs, step):
        """Replay (card) or run (CPU) one chunk; returns its metrics."""
        return step.replay() if on_card else chunk_body(prog, n_rounds)(inputs)

    def release(staged):
        if staged["pool"] is not None:
            ev = torch.cuda.Event()
            ev.record()
            staged["pool"].release(ev)

    def schedule_for(chunk):
        return chunk_schedule(
            start_round, rounds, chunk,
            eval_every=None if eval_in_chunk else eval_every,
            ckpt_every=checkpoint_every if checkpoint_dir else None,
            per_round=callback is not None)

    # --- chunk size: fixed or calibrated ----------------------------------
    chunk_rounds = superstep_rounds
    calibration_s = None
    if superstep_rounds == "auto":
        t_calib = time.perf_counter()
        calib = _calibration_source(data, seed)
        calib_graphs: Dict[int, _GraphStep] = {}
        calib_noise = (make_noise_source(uplink, downlink, seed ^ 0xCA11B,
                                         device) if uses_noise else None)

        def timed(n_rounds):
            staged = build_chunk(0, n_rounds, src=calib)
            inputs, step = load_chunk_inputs(
                prog, n_rounds, staged, draw_noise(0, n_rounds, calib_noise),
                calib_graphs)
            if compressed and ef_paged:
                for d, s in zip(inputs["ef_page"], staged["ef_page"]):
                    d.copy_(s)
            state0 = _host_snapshot(carried_tensors(prog, inputs))
            step = captured(n_rounds, inputs, step,    # outside the timing
                            calib_graphs)
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_chunk(n_rounds, inputs, step)
            if on_card:
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            _restore(carried_tensors(prog, inputs), state0)
            return elapsed

        chunk_rounds = _auto_chunk_rounds(timed)
        if shard is not None:   # the ranks' timings differ: rank 0 decides
            chunk_rounds = _broadcast_int(chunk_rounds, shard, device)
        # the chosen length's graph serves the run (its calibration replay
        # is not one of the run's) if the run has chunks of that length
        # (eval and checkpoint boundaries may cut every chunk shorter); the
        # other graphs and their memory are freed
        kept = calib_graphs.pop(chunk_rounds, None)
        if kept is not None and chunk_rounds in {
                r1 - r0 for r0, r1 in schedule_for(chunk_rounds)}:
            kept.replays = 0
            graphs[chunk_rounds] = kept
        calib_graphs.clear()
        if on_card:
            torch.cuda.empty_cache()
        calibration_s = time.perf_counter() - t_calib
        if verbose and writer:
            print(f"engine: auto chunk size -> {chunk_rounds} rounds")

    # --- schedule, prefetch pipeline, metrics -----------------------------
    schedule = schedule_for(chunk_rounds)
    rl.event("run.start", rounds=rounds, start_round=start_round,
             chunk_rounds=chunk_rounds, compressed=compressed,
             client_shards=n_shards, telemetry=tele is not None,
             participation=policy.name if part_active else None,
             controller=fl.controller if ctrl_active else None,
             ef_store=("host" if ef_paged else "device") if compressed
                      else None)
    prefetcher = HostPrefetcher(build_chunk, schedule, enabled=prefetch,
                                runlog=rl)
    ctrl_schedule = None
    if ctrl_active:
        # per-round CommLog accounting: the drained tele/level indexes
        # these host tables, so each round is charged its level's bytes
        eff_key = ("eff_topk_frac" if ctrl_spec.kind == "topk_frac"
                   else "eff_quant_bits")
        ctrl_schedule = {
            "bytes": [float(b) for b in ctrl_spec.bytes_up],
            "effective": [
                {"level": i,
                 eff_key: (float(v) if ctrl_spec.kind == "topk_frac"
                           else int(v))}
                for i, v in enumerate(ctrl_spec.values)],
        }
    pump = MetricsPump(comm, c_round, wire_up=wire_up, wire_down=wire_down,
                       n_down=(data.n_clients
                               if compressed and fl.downlink_codec
                               != "identity" else None),
                       verbose=verbose and writer, runlog=rl,
                       schedule=ctrl_schedule)
    # chunk timing: CUDA events on the dispatch stream (the card's own
    # timeline, no host sync), host clock on the CPU
    marks: List[Tuple[int, int, object, object, object]] = []

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # profile_dir: one torch.profiler trace of the whole run (the card's
    # kernels and graph launches too), one "superstep" range per chunk
    profiler = profile_path = None
    if profile_dir and writer:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(profile_dir, exist_ok=True)
        profile_path = os.path.join(profile_dir, "engine_trace.json")
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))

    def chunk_range():
        if profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("superstep")

    halted_at = None
    t_run = time.perf_counter()
    if profiler is not None:
        profiler.start()
    try:
        with pump:
            for r0, r1, staged in prefetcher:
                n_rounds = r1 - r0
                with chunk_range():
                    with rl.span("chunk.dispatch", r0=r0, r1=r1,
                                 compile=n_rounds not in (
                                     graphs if on_card else prog.supersteps)):
                        m_start = mark()
                        inputs, step = load_chunk_inputs(
                            prog, n_rounds, staged,
                            draw_noise(r0, r1, noise_fn), graphs)
                        if compressed and ef_paged:
                            page = [p.to(device, non_blocking=True)
                                    for p in staged["ef_page"]]
                            pager.patch(staged["ef_plan"], page,
                                        inputs["ef_page"])
                        release(staged)
                        step = captured(n_rounds, inputs, step)
                        m_run = mark()
                        mstack = run_chunk(n_rounds, inputs, step)
                        marks.append((r0, r1, m_start, m_run, mark()))
                        if compressed and ef_paged:
                            pager.complete(staged["ef_plan"],
                                           inputs["ef_page"])
                    eval_metrics = None
                    if eval_every and not eval_in_chunk \
                            and r1 % eval_every == 0:
                        with rl.span("eval.dispatch", round=r1,
                                     overlap=False):
                            eval_metrics = eval_fn(global_state, test_batch,
                                                   test_mask)
                pump.submit(mstack, eval_metrics, host=staged.get("host"))
                if callback is not None:      # one-round chunks
                    pump.drain()
                    metrics = {k: v for k, v in comm.history[-1].items()
                               if k not in _NON_METRIC_KEYS}
                    callback(r0, global_state, metrics)
                if halt_on_nonfinite:
                    # the drain costs the metrics overlap: the price of
                    # the option (off by default)
                    pump.drain()
                    if pump.nonfinite_round is not None:
                        rl.event("run.halt", reason="metrics.nonfinite",
                                 round=pump.nonfinite_round, boundary=r1)
                        if checkpoint_dir:
                            with rl.span("checkpoint.save", round=r1,
                                         halt=True):
                                save_checkpoint(r1, halted=True)
                        halted_at = r1
                        break
                if checkpoint_dir and r1 % checkpoint_every == 0:
                    with rl.span("checkpoint.save", round=r1):
                        save_checkpoint(r1)
    finally:
        if pager is not None:
            pager.close()
        prefetcher.close()
        if profiler is not None:
            profiler.stop()
    m_end = mark()
    if on_card:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    chunk_times = _chunk_times(marks, m_end, on_card)
    if profiler is not None:
        profiler.export_chrome_trace(profile_path)

    if checkpoint_dir and halted_at is None:
        with rl.span("checkpoint.save", round=rounds, final=True):
            save_checkpoint(rounds)
    stats = {
        "device": str(device),
        "client_shards": n_shards,
        "fused_collective": bool(shard is not None and fused_collective),
        "sharded_eval": eval_fn is not None and eval_shard is not None,
        "collectives": (shard.collectives - collectives0
                        if shard is not None else 0),
        "cuda_graphs": on_card,
        "chunk_rounds": chunk_rounds,
        "calibration_s": calibration_s,
        "chunks": len(schedule),
        "run_s": run_s,
        # per chunk: start (ms after the first chunk's start) and the ms
        # of its superstep (the graph replay on the card), on the card's
        # timeline; steady rate = rounds after the first chunk over the
        # time from the second chunk's start to the end of the run
        "chunk_times": chunk_times,
        "steady_rounds_per_s": _steady_rate(chunk_times),
        "eval_in_chunk": eval_in_chunk,
        "host_wait_s": prefetcher.wait_s,
        "metrics_wait_s": pump.wait_s,
        "staging_pool_hits": sum(p.hits for p in pools) if pools else 0,
        "staging_pool_misses": sum(p.misses for p in pools) if pools else 0,
        "ef_store": ("host" if ef_paged else "device") if compressed
                    else None,
        "graphs": [graphs[k].stats() for k in sorted(graphs)],
        "participation": policy.name if part_active else None,
        "round_cohort": c_round,
        "telemetry": tele is not None,
        "halted_at": halted_at,
        "controller": fl.controller if ctrl_active else None,
        "ladder": list(ctrl_spec.values) if ctrl_active else None,
        "profile": profile_path,
    }
    if ef_paged:
        stats["ef_page_bytes"] = pager.page_rows_max * store.row_nbytes()
        stats["ef_store_rows"] = store.n_rows
        stats["ef_patched_rows"] = pager.patched_rows
        stats["ef_stall_s"] = pager.stall_s
        rl.counter("ef.page.hits", store.hits)
        rl.counter("ef.page.misses", store.misses)
        rl.counter("ef.page.writeback_rows", store.writeback_rows)
        rl.counter("ef.page.patched_rows", pager.patched_rows)
        rl.counter("ef.page.stall_s", round(pager.stall_s, 4))
    rl.counter("prefetch.wait_s", round(prefetcher.wait_s, 4))
    rl.counter("metrics.wait_s", round(pump.wait_s, 4))
    if pools:
        rl.counter("staging.pool_hits", stats["staging_pool_hits"])
        rl.counter("staging.pool_misses", stats["staging_pool_misses"])
    rl.event("run.end", rounds=rounds)
    if owns_runlog:
        rl.close()
    if rl.path:
        stats["runlog"] = rl.path
    return ServerResult(global_state=global_state, comm=comm, stats=stats)
