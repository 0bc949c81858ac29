"""Config matrix and superstep lowering for the invariant analyzer (port
of ``repro/analysis/lower.py``).

The analyzer never trains: every lowered pass reads the op record of one
chunk built for one :class:`SuperstepSpec`, a point in the mode × codec ×
telemetry × participation × controller × ef_store × sharding matrix.
This module owns that construction, so the passes, the CLI and the tests
all run the exact program the engine captures
(:func:`repro_torch.engine.engine.chunk_body`), on the exact buffers it
carries in place (:func:`~repro_torch.engine.engine.carried_tensors`),
staged as the engine stages them
(:func:`~repro_torch.engine.engine.load_chunk_inputs`).

"Lowering" a point runs that chunk body once under the op recorder
(:mod:`repro_torch.analysis.records`), on concrete tensors at the
fixture's sizes drawn from a seeded ``torch.Generator`` (the port has no
abstract arguments):

* on the card, inside the engine's own ``_GraphStep`` capture, with the
  recorder active during the capture; a capture refuses a host sync, so a
  planted sync shows up as a capture error;
* on the CPU, in one eager run after an unrecorded one (the card's
  warm-up), the carried state put back in between.

Each point is lowered at K and at K + 1 rounds, each time with fresh
state (the body writes the carried state in place), so a pass can tell
the round body from what surrounds it (``records.per_round``).

Sharded points run over a :class:`repro_torch.core.aggregate.
ClientSharding` of the default process group: on the CPU a gloo group of
``--devices`` ranks that the CLI spawns, on the card a one-rank NCCL
group.  The fixture is the tests' tiny 8×8 CNN with 8 clients: the
invariants are shape-independent and a small model keeps the matrix cheap.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.records import OpRecord, OpRecorder, storage_key
from repro_torch.analysis.registry import AnalysisFailure
from repro_torch.compress import make_codec
from repro_torch.configs import CNN_CONFIGS
from repro_torch.configs.base import FLConfig
from repro_torch.control import (LadderSpec, ladder_kind, ladder_values,
                                 make_controller)
from repro_torch.core.aggregate import ClientSharding
from repro_torch.core.rounds import init_global_state
from repro_torch.device import resolve_device
from repro_torch.engine import engine as eng
from repro_torch.engine.efstore import plan_chunk_static
from repro_torch.fl.participation import make_policy
from repro_torch.fl.server import make_noise_source
from repro_torch.kernels import calls
from repro_torch.launch.sharding import client_block
from repro_torch.models.registry import make_bundle
from repro_torch.obs.telemetry import make_telemetry
from repro_torch.optim import exp_decay_per_round
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["N_CLIENTS", "CLIENTS_PER_ROUND", "INPUT_SHAPE", "CODEC_CASES",
           "analysis_bundle", "SuperstepSpec", "fl_for", "Lowering",
           "LoweredSuperstep", "default_shard", "lower_superstep",
           "default_matrix"]

# Fixture federation: the JAX analyzer's, so every point id and every
# count talks about the same program family.
N_CLIENTS = 8
CLIENTS_PER_ROUND = 4
INPUT_SHAPE = (8, 8, 1)

# Codec cases (fl overrides per case): identity wire, stateful top-k EF,
# stateless int8, asymmetric int8-up/topk-down, and the fedfusion
# algorithm on a top-k wire.
CODEC_CASES = {
    "plain": dict(),
    "topk": dict(uplink_codec="topk", topk_frac=0.1),
    "int8": dict(uplink_codec="int8"),
    "quant+downtopk": dict(uplink_codec="int8", downlink_codec="topk",
                           topk_frac=0.1),
    "fusion-topk": dict(algorithm="fedfusion", fusion_op="conv",
                        uplink_codec="topk", topk_frac=0.1),
}


@functools.lru_cache(maxsize=1)
def analysis_bundle():
    """The analyzer's model fixture: the tests' tiny 8×8 CNN."""
    cfg = dataclasses.replace(CNN_CONFIGS["cnn_mnist"],
                              input_shape=INPUT_SHAPE, conv_channels=(4,),
                              fc_units=(8,), dropout=0.0)
    return make_bundle(cfg)


@dataclass(frozen=True)
class SuperstepSpec:
    """One point of the analysis matrix.

    ``codec`` keys :data:`CODEC_CASES`; ``controller`` is a
    ``repro_torch.control`` registry name (``"static"`` = off); ``fused``
    only matters when ``sharded`` (the unsharded superstep has no
    collectives at all); ``ef_store="host"`` lowers against the
    cohort-paged EF page instead of the dense table.
    """
    mode: str = "client_parallel"
    codec: str = "plain"
    sharded: bool = False
    fused: bool = True
    telemetry: bool = False
    participation: bool = False
    controller: str = "static"
    ef_store: str = "device"
    n_rounds: int = 4

    @property
    def compressed(self) -> bool:
        return bool(CODEC_CASES[self.codec])

    @property
    def point(self) -> str:
        """Stable id for reports and findings (the JAX analyzer's)."""
        bits = [self.mode, self.codec,
                ("fused" if self.fused else "unfused") if self.sharded
                else "unsharded"]
        if self.telemetry:
            bits.append("tele")
        if self.participation:
            bits.append("part")
        if self.controller != "static":
            bits.append(f"ctrl={self.controller}")
        if self.ef_store != "device":
            bits.append(f"ef={self.ef_store}")
        return "/".join(bits)


def fl_for(spec: SuperstepSpec) -> FLConfig:
    """The :class:`FLConfig` the engine would run at this matrix point."""
    kw = dict(CODEC_CASES[spec.codec])
    algo = kw.pop("algorithm", "fedavg")
    if spec.participation:
        kw.update(participation="deadline", over_provision=1.5)
    if spec.controller != "static":
        kw.update(controller=spec.controller)
    return FLConfig(algorithm=algo, clients_per_round=CLIENTS_PER_ROUND,
                    local_steps=2, local_batch=4, lr=0.05, **kw)


@dataclass
class Lowering:
    """One run of the chunk body at ``n_rounds`` under the recorder.

    ``carried``: per buffer the engine carries in place, ``(shape,
    data_ptr before, after, _version before, after)`` over the recorded
    run; ``carried_storages`` / ``ef_storages``: the memory of every
    carried buffer and of the EF table (or page) leaves
    (``records.storage_key``);
    ``collectives`` / ``collective_bytes``: what the run issued through
    the :class:`ClientSharding`; on the card ``launches`` (the kernel
    counters' deltas over the capture), ``capture_error`` (a capture the
    card refused) and ``replay_error`` (``_GraphStep.replay``'s pointer
    check)."""
    n_rounds: int
    record: OpRecord
    carried: List[Tuple] = field(default_factory=list)
    carried_storages: frozenset = frozenset()
    ef_storages: frozenset = frozenset()
    collectives: int = 0
    collective_bytes: int = 0
    launches: Optional[Dict[str, int]] = None
    capture_error: Optional[str] = None
    replay_error: Optional[str] = None
    graph: Optional[Dict] = None


@dataclass
class LoweredSuperstep:
    """A point lowered at K and at K + 1 rounds.

    ``lowerings`` holds both runs; ``record`` / ``record_next`` are their
    op records.  ``ef_rows`` is this rank's EF rows (its block with the
    scratch row when sharded; the chunk's page with ``ef_store="host"``);
    the wire model (``wire_up``, ``wire_down``, ``level_bytes``) is the
    bound codecs', as the engine charges it."""
    spec: SuperstepSpec
    fl: FLConfig
    device: torch.device
    cohort: int
    lowerings: Tuple[Lowering, Lowering]
    ef_rows: Optional[int] = None
    uplink: object = None
    downlink: object = None
    controller: object = None
    shard: Optional[ClientSharding] = None
    wire_up: Optional[int] = None
    wire_down: Optional[int] = None
    level_bytes: Optional[Tuple[int, ...]] = None
    model_sizes: Tuple[int, ...] = ()

    @property
    def point(self) -> str:
        return self.spec.point

    @property
    def n_rounds(self) -> int:
        return self.lowerings[0].n_rounds

    @property
    def record(self) -> OpRecord:
        return self.lowerings[0].record

    @property
    def record_next(self) -> OpRecord:
        return self.lowerings[1].record

    @property
    def ideal_model_bytes(self) -> int:
        """Uncompressed f32 wire bytes of one model delta (the CommLog
        'ideal' baseline every codec's wire bytes are charged against)."""
        return 4 * sum(self.model_sizes)


def _ef_rows(spec: SuperstepSpec, n_rounds: int, cohort: int,
             n_shards: int) -> int:
    """This rank's EF rows: the page of a chunk (``K * cohort``, plus a
    scratch row when sharded), the resident block with its scratch row
    (sharded), or the dense table."""
    if spec.ef_store == "host":
        return n_rounds * cohort + (1 if spec.sharded else 0)
    if spec.sharded:
        return N_CLIENTS // n_shards + 1
    return N_CLIENTS


def default_shard() -> ClientSharding:
    """The client split over every rank of the default process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise AnalysisFailure(
            "sharded analysis points need a process group (the "
            "repro_torch.analysis CLI spawns gloo ranks on the CPU; on the "
            "card open a one-rank NCCL group)")
    return ClientSharding(("data",), (dist.get_world_size(),),
                          position=dist.get_rank())


class _Watch:
    """Around the recorded run: the carried buffers' pointers and versions,
    the shard's collective counters and the kernel counters, before and
    after."""

    def __init__(self, low: Lowering, carried, shard):
        self.low, self.carried, self.shard = low, carried, shard
        self.recorder = OpRecorder()

    def __enter__(self):
        self._before = [(t.data_ptr(), t._version) for t in self.carried]
        self._coll = ((self.shard.collectives, self.shard.collective_bytes)
                      if self.shard is not None else (0, 0))
        self._launches = calls.launch_counts()
        self.recorder.__enter__()
        return self

    def __exit__(self, *exc):
        self.recorder.__exit__(*exc)
        self.low.record = self.recorder.record
        if exc[0] is not None:
            return False
        self.low.carried = [
            (tuple(t.shape), p0, t.data_ptr(), v0, t._version)
            for t, (p0, v0) in zip(self.carried, self._before)]
        if self.shard is not None:
            self.low.collectives = self.shard.collectives - self._coll[0]
            self.low.collective_bytes = (self.shard.collective_bytes
                                         - self._coll[1])
        after = calls.launch_counts()
        self.low.launches = {k: after[k] - self._launches[k] for k in after
                             if after[k] != self._launches[k]}
        return False


def _staged_chunk(spec, fl, n_rounds, cohort, shard, paged, ef_leaves, gen):
    """The chunk the engine's prefetcher would stage, at the fixture's
    sizes (host tensors; this rank's blocks of the client axis)."""
    n_shards = shard.n_shards if shard is not None else 1
    K, C = n_rounds, cohort
    H, W, Ch = INPUT_SHAPE
    x = torch.randn((K, C, fl.local_steps, fl.local_batch, H, W, Ch),
                    generator=gen)
    y = torch.randint(0, 10, (K, C, fl.local_steps, fl.local_batch),
                      generator=gen, dtype=torch.int32)
    sizes = torch.randint(10, 50, (K, C), generator=gen).float()
    cids = torch.stack([torch.randperm(N_CLIENTS, generator=gen)[:C]
                        for _ in range(K)]).to(torch.int32)
    staged = {"batches": {"x": client_block(x, shard),
                          "y": client_block(y, shard)},
              "lrs": torch.tensor([exp_decay_per_round(fl.lr, fl.lr_decay)(r)
                                   for r in range(K)], dtype=torch.float32)}
    if spec.participation:
        mask = (torch.rand((K, C), generator=gen) > 0.25).float()
        stale = torch.rand((K, C), generator=gen)
        sizes = sizes * mask
        staged["part"] = (client_block(mask, shard),
                          client_block(stale, shard))
    staged["sizes"] = client_block(sizes, shard)
    if paged:
        plan = plan_chunk_static(cids.numpy(), n_shards)
        staged["cids"] = torch.from_numpy(plan.vcids)
        rows = plan.p_loc + (1 if shard is not None else 0)
        staged["ef_page"] = [torch.zeros((rows,) + tuple(z.shape))
                             for z in ef_leaves]
    else:
        staged["cids"] = cids
    return staged


def _lower_at(spec: SuperstepSpec, n_rounds: int, *, inner_wrap, device,
              shard) -> Tuple[Lowering, Dict]:
    bundle = analysis_bundle()
    fl = fl_for(spec)
    compressed = fl.compressed
    ctrl_active = compressed and spec.controller != "static"
    n_shards = shard.n_shards if shard is not None else 1
    cohort = CLIENTS_PER_ROUND
    if spec.participation:
        cohort = make_policy(fl.participation).cohort_size(
            CLIENTS_PER_ROUND, fl)
    if shard is not None and cohort % n_shards:
        raise AnalysisFailure(f"cohort {cohort} does not divide over "
                              f"{n_shards} shards at {spec.point}")
    gen = torch.Generator().manual_seed(n_rounds)
    state = init_global_state(bundle, fl, torch.Generator().manual_seed(0),
                              device)
    info = dict(fl=fl, cohort=cohort, model_sizes=tuple(
        t.numel() for t in tree_leaves(state["model"])))

    uplink = downlink = controller = ctrl_state = None
    ef_leaves, ef_all, paged, mirror = [], None, False, None
    if compressed:
        uplink = make_codec(fl.uplink_codec, topk_frac=fl.topk_frac,
                            quant_bits=fl.quant_bits)
        downlink = make_codec(fl.downlink_codec, topk_frac=fl.topk_frac,
                              quant_bits=fl.quant_bits)
        uplink.bind(state["model"])
        downlink.bind(state["model"])
        info.update(uplink=uplink, downlink=downlink,
                    wire_up=uplink.wire_bytes(),
                    wire_down=downlink.wire_bytes())
        if ctrl_active:
            ladder = ladder_values(fl)
            uplink.set_ladder(ladder)
            level_bytes = tuple(uplink.level_bytes())
            controller = make_controller(spec.controller).setup(
                LadderSpec(kind=ladder_kind(fl.uplink_codec), values=ladder,
                           bytes_up=level_bytes), fl, device)
            ctrl_state = controller.init_state()
            info.update(level_bytes=level_bytes, controller=controller)
        ef_leaves = [z for z in uplink.init_state() if z is not None]
        paged = bool(ef_leaves) and spec.ef_store == "host"
        if ef_leaves:
            rows = _ef_rows(spec, n_rounds, cohort, n_shards)
            info["ef_rows"] = rows
            if not paged:
                ef_all = [torch.zeros((rows,) + tuple(z.shape), device=device)
                          for z in ef_leaves]
        mirror = tree_map(torch.clone, state["model"])

    tele = None
    if spec.telemetry or ctrl_active:
        tele = make_telemetry(
            "compressed" if compressed else "plain", n_clients=cohort,
            n_shards=n_shards,
            available=frozenset(
                (("ef",) if compressed and uplink.stateful else ())
                + (("pmask", "staleness") if spec.participation else ())
                + (("level", "eff_bytes") if ctrl_active else ())))
        if ctrl_active:
            have = {t.name for t in tele.taps}
            missing = [n for n in controller.requires_taps if n not in have]
            if missing:
                raise AnalysisFailure(
                    f"controller {spec.controller!r} needs taps {missing} "
                    f"unavailable for codec {spec.codec!r} at {spec.point}")

    prog = eng.ChunkProgram(
        bundle=bundle, fl=fl, mode=spec.mode, device=device,
        global_state=state, uplink=uplink, downlink=downlink,
        down_mirror=mirror, ef_all=ef_all, ef_paged=paged, tele=tele,
        controller=controller, ctrl_state=ctrl_state, shard=shard,
        fused=spec.fused, part_active=spec.participation)
    eng.chunk_body(prog, n_rounds)          # builds the superstep
    if inner_wrap is not None:
        prog.supersteps[n_rounds] = inner_wrap(prog.supersteps[n_rounds])
    body = eng.chunk_body(prog, n_rounds)

    staged = _staged_chunk(spec, fl, n_rounds, cohort, shard, paged,
                           ef_leaves, gen)
    noise = (None, None)
    if compressed and (uplink.uses_noise or downlink.uses_noise):
        down, up = eng._stack_noise(
            make_noise_source(uplink, downlink, 0, device), 0, n_rounds,
            cohort)
        if up is not None and shard is not None:
            up = [client_block(u, shard) for u in up]
        noise = (down, up)
    inputs, _ = eng.load_chunk_inputs(prog, n_rounds, staged, noise, {})
    if paged and not prog.on_card:        # what the pager's patch fills
        for d, s in zip(inputs["ef_page"], staged["ef_page"]):
            d.copy_(s)
    carried = eng.carried_tensors(prog, inputs)
    ef = inputs["ef_page"] if paged else ef_all or []
    low = Lowering(n_rounds=n_rounds, record=OpRecord(),
                   carried_storages=frozenset(map(storage_key, carried)),
                   ef_storages=frozenset(map(storage_key, ef)))
    watch = _Watch(low, carried, shard)
    if prog.on_card:
        try:
            step = eng._GraphStep(n_rounds, inputs, body, carried, shard,
                                  capture_mode=watch)
        except Exception as e:    # a capture the card refused is a finding
            low.capture_error = f"{type(e).__name__}: {e}"
            torch.cuda.synchronize()
        else:
            low.graph = step.stats()
            try:
                step.replay()
            except RuntimeError as e:
                low.replay_error = str(e)
            torch.cuda.synchronize()
    else:
        # the card records the capture after the engine's warm-up runs,
        # which make what the body makes on first use (a codec's ladder
        # tables); so here too: one run, the carried state put back, then
        # the recorded run
        snapshot = eng._host_snapshot(carried)
        body(inputs)
        eng._restore(carried, snapshot)
        with watch:
            body(inputs)
    return low, info


def lower_superstep(spec: SuperstepSpec, *, inner_wrap=None, device=None,
                    shard: Optional[ClientSharding] = None
                    ) -> LoweredSuperstep:
    """Build and record the chunk at one matrix point, at K and K + 1
    rounds, on ``device`` (the card unless another device is named).

    ``inner_wrap`` wraps the superstep (the mutation tests use it to seed
    violations).  ``shard``: the client split of sharded points (default
    :func:`default_shard`, every rank of the default process group).
    """
    if spec.codec not in CODEC_CASES:
        raise AnalysisFailure(f"unknown codec case {spec.codec!r}; have "
                              f"{tuple(sorted(CODEC_CASES))}")
    device = resolve_device(device)
    if spec.sharded:
        shard = shard if shard is not None else default_shard()
    else:
        shard = None
    lows = []
    for k in (spec.n_rounds, spec.n_rounds + 1):
        low, info = _lower_at(spec, k, inner_wrap=inner_wrap, device=device,
                              shard=shard)
        lows.append(low)
    return LoweredSuperstep(spec=spec, device=device, lowerings=tuple(lows),
                            shard=shard, **info)


def default_matrix(preset: str = "quick", *,
                   sharded: Optional[bool] = None) -> List[SuperstepSpec]:
    """The analyzer's config matrix, the JAX analyzer's point for point.

    A covering design, not a full cross-product: a base mode × codec grid
    with everything else off, one point per extra feature (telemetry /
    participation / each controller / paged EF store), and everything-on
    points: 18 specs for ``"quick"``, 32 for ``"full"``.  ``sharded``
    filters: True keeps only sharded points, False only unsharded ones.
    """
    if preset not in ("quick", "full"):
        raise AnalysisFailure(f"unknown preset {preset!r}")
    S = SuperstepSpec
    specs: List[SuperstepSpec] = []
    for codec in CODEC_CASES:
        specs.append(S(codec=codec))
        specs.append(S(codec=codec, sharded=True))
    specs.append(S(codec="topk", sharded=True, fused=False))
    specs.append(S(codec="topk", telemetry=True))
    specs.append(S(codec="topk", sharded=True, telemetry=True))
    specs.append(S(codec="topk", sharded=True, participation=True))
    specs.append(S(codec="topk", sharded=True, controller="ef_ratio"))
    specs.append(S(codec="topk", ef_store="host"))
    specs.append(S(codec="topk", sharded=True, ef_store="host"))
    specs.append(S(codec="topk", sharded=True, telemetry=True,
                   participation=True, controller="ef_ratio",
                   ef_store="host"))
    if preset == "full":
        specs.append(S(mode="client_sequential", codec="topk"))
        specs.append(S(mode="client_sequential", codec="topk",
                       sharded=True))
        specs.append(S(codec="plain", sharded=True, fused=False))
        specs.append(S(codec="quant+downtopk", sharded=True, fused=False))
        specs.append(S(codec="fusion-topk", sharded=True, fused=False))
        specs.append(S(codec="topk", participation=True))
        specs.append(S(codec="topk", controller="ef_ratio"))
        specs.append(S(codec="topk", controller="bytes_budget"))
        specs.append(S(codec="topk", controller="loss_trend"))
        specs.append(S(codec="topk", sharded=True,
                       controller="bytes_budget"))
        specs.append(S(codec="topk", sharded=True,
                       controller="loss_trend"))
        specs.append(S(codec="quant+downtopk", sharded=True,
                       telemetry=True))
        specs.append(S(codec="topk", sharded=True, fused=False,
                       telemetry=True, participation=True,
                       controller="ef_ratio"))
        specs.append(S(codec="topk", telemetry=True, participation=True,
                       controller="ef_ratio", ef_store="host"))
    if sharded is not None:
        specs = [s for s in specs if s.sharded == sharded]
    return specs
