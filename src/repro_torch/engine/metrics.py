"""Deferred metrics (port of ``repro/engine/metrics.py``): a chunk's
stacked ``[K]`` device metrics reach the ``CommLog`` through a worker
thread, so the dispatch thread never waits for the card mid-run.

On the card, ``submit`` enqueues a ``copy_(..., non_blocking=True)`` of
every metric into page-locked host memory and records a CUDA event after
the copies; the worker waits on that event (never on
``torch.cuda.synchronize()``), then reads the host copies.  The copies are
enqueued on the dispatch stream before the next graph replay, so they
finish before the replay overwrites the graph's static outputs.  On the
CPU the copy is synchronous and the worker only logs.

``MetricsPump`` is a context manager: a clean exit drains every pending
chunk into the ``CommLog``, an exception cancels what is queued without
blocking the raising thread.

Each logged round is scanned for non-finite values: the first such round
is kept in ``nonfinite_round`` (the engine's ``halt_on_nonfinite`` reads
it) and every such round emits a ``metrics.nonfinite`` warning into the
run log.  With an adaptive controller's ``schedule``, each round's drained
``tele/level`` picks the level's effective uplink bytes and codec fields
for ``CommLog.log_round(effective=...)``.
"""
from __future__ import annotations

import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.obs.runlog import as_runlog

__all__ = ["MetricsPump"]


def _to_host(tree: Optional[Dict[str, torch.Tensor]]):
    """(host copies, event or None): pinned non-blocking copies plus an
    event after them for card tensors, plain clones for CPU tensors."""
    if not tree:
        return tree, None
    event = None
    out = {}
    for k, v in tree.items():
        if v.device.type == "cuda":
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            out[k] = host
        else:
            out[k] = v.detach().clone()
    if any(v.device.type == "cuda" for v in tree.values()):
        event = torch.cuda.Event()
        event.record()
    return out, event


class MetricsPump:
    """Feed per-round metrics into a ``repro_torch.fl.comm.CommLog``
    without blocking.

    ``comm`` must have its wire sizes bound (``comm.bind_sizes``): the
    pump logs with ``global_state=None``.  ``wire_up`` / ``wire_down`` /
    ``n_down`` are the per-run constants of ``CommLog.log_round``.
    ``runlog`` (None | RunLog) receives non-finite metric warnings;
    ``schedule`` (an adaptive controller's ``{"bytes": [...], "effective":
    [...]}`` per level) turns each round's ``tele/level`` into its
    effective uplink bytes and codec fields.
    """

    def __init__(self, comm, n_clients: int, *,
                 wire_up: Optional[int] = None,
                 wire_down: Optional[int] = None,
                 n_down: Optional[int] = None,
                 verbose: bool = False, max_pending: int = 4,
                 runlog=None, schedule: Optional[dict] = None):
        self._comm = comm
        self._n_clients = n_clients
        self._wire = dict(wire_up=wire_up, wire_down=wire_down,
                          n_down=n_down)
        self._schedule = schedule
        self._verbose = verbose
        self._max_pending = max_pending
        self._runlog = as_runlog(runlog)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="engine-metrics")
        self._pending: deque = deque()
        self.wait_s = 0.0    # dispatch-thread time blocked on metrics
        # first round whose metrics held a non-finite value (1-based), or
        # None; the engine's halt_on_nonfinite reads it
        self.nonfinite_round: Optional[int] = None

    def __enter__(self) -> "MetricsPump":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False

    def submit(self, metrics_stack, eval_metrics=None, host=None):
        """Queue one chunk: ``metrics_stack`` maps names to [K] tensors;
        ``eval_metrics`` (0-d tensors, or None) merge into the chunk's last
        round (the engine cuts chunks at eval rounds).  ``host`` (optional)
        carries per-round values computed on the host, never on the
        device: ``host["metrics"]`` maps names to [K] arrays merged into
        each round, and ``host["n_up"]`` ([K] int) is each round's uplink
        count for ``CommLog.log_round(n_up=)`` (partial participation).
        Blocks only when more than ``max_pending`` chunks are queued
        (``wait_s``)."""
        stack, ev_stack = _to_host(metrics_stack)
        evals, ev_eval = _to_host(eval_metrics)

        def fetch():
            for ev in (ev_stack, ev_eval):
                if ev is not None:
                    ev.synchronize()
            return ({k: v.numpy() for k, v in stack.items()},
                    None if evals is None else
                    {k: v.numpy() for k, v in evals.items()}, host)

        self._pending.append(self._pool.submit(fetch))
        while len(self._pending) > self._max_pending:
            t0 = time.perf_counter()
            fetched = self._pending.popleft().result()
            self.wait_s += time.perf_counter() - t0
            self._log(fetched)

    def drain(self):
        """Resolve every pending chunk into the CommLog (host blocks)."""
        t0 = time.perf_counter()
        while self._pending:
            self._log(self._pending.popleft().result())
        self.wait_s += time.perf_counter() - t0

    def close(self):
        self.drain()
        self._pool.shutdown(wait=True)

    def abort(self):
        """Exception path: cancel queued fetches and retire the worker
        without draining."""
        while self._pending:
            self._pending.popleft().cancel()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _log(self, fetched):
        stack, ev, host = fetched
        n_rounds = (len(next(iter(stack.values()))) if stack
                    else (1 if ev is not None else 0))
        host_metrics = host.get("metrics", {}) if host else {}
        n_up = host.get("n_up") if host else None
        for k in range(n_rounds):
            metrics = {key: float(v[k]) for key, v in stack.items()}
            metrics.update({key: float(v[k])
                            for key, v in host_metrics.items()})
            if ev is not None and k == n_rounds - 1:
                metrics.update({key: float(np.asarray(v))
                                for key, v in ev.items()})
            bad = [key for key, v in metrics.items() if not math.isfinite(v)]
            if bad:
                # the value still lands in the history; the event makes it
                # findable
                self._runlog.warning("metrics.nonfinite",
                                     round=self._comm.rounds + 1, keys=bad)
                if self.nonfinite_round is None:
                    self.nonfinite_round = self._comm.rounds + 1
            wire, effective = self._wire, None
            if self._schedule is not None and "tele/level" in metrics:
                lvl = int(round(metrics["tele/level"]))
                lvl = max(0, min(lvl, len(self._schedule["bytes"]) - 1))
                wire = dict(self._wire,
                            wire_up=int(round(self._schedule["bytes"][lvl])))
                effective = self._schedule["effective"][lvl]
            self._comm.log_round(None, self._n_clients, metrics,
                                 n_up=None if n_up is None else int(n_up[k]),
                                 effective=effective, **wire)
            if self._verbose:
                print(f"round {self._comm.rounds:4d} " +
                      " ".join(f"{k2}={v2:.4f}" for k2, v2 in
                               metrics.items()))
