"""Host pipeline of the engine (port of ``repro/engine/pipeline.py``):
stage chunk i+1 while chunk i trains, and write device results back off
the dispatch thread.

``HostPrefetcher`` runs the chunk builder on one background thread that
walks the chunk schedule in order (one thread, because the data rng
stream must advance in exactly the reference loop's per-round order) and
hands the built chunks to the consumer through a bounded queue (depth 2:
one chunk being consumed, one in flight).

``StagingPool`` keeps the big stacked host arrays a chunk builder fills
alive across chunks, in page-locked memory (``pin_memory=True``) when it
feeds a card, so the dispatch thread's ``copy_(..., non_blocking=True)``
into the captured graph's static inputs is a true asynchronous DMA.  A
pool must not be refilled while a copy out of it is in flight: the
consumer ``release``-s it with a CUDA event recorded after its copies,
and the builder's ``acquire`` waits for that event (on the prefetch
thread, never the dispatch thread).

``WritebackLane`` is the reverse direction: a single serialized worker
draining device results into host state (the cohort-paged EF store writes
each chunk's rows back through one, see ``repro_torch.engine.efstore``),
with a completion counter so a producer can wait for a prefix of the
submitted work.

Both threads report to an optional run log (``repro_torch.obs.runlog``):
the prefetcher records one ``prefetch.stage`` span per chunk on its own
thread, and ``close()`` of either turns a thread that did not retire or an
error nobody saw into a structured warning (``prefetch.join_timeout`` /
``prefetch.error``, ``writeback.join_timeout`` / ``writeback.error``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.obs.runlog import as_runlog

__all__ = ["StagingPool", "WritebackLane", "HostPrefetcher"]


class StagingPool:
    """Reusable host staging buffers, keyed by name, matched on shape and
    dtype.

    ``take(name, shape, dtype)`` returns a writable ndarray; the same name
    returns the same memory while shape and dtype are stable (chunk shapes
    change only at schedule tails).  ``pin=True`` backs every buffer with
    a page-locked torch tensor (``tensor(name)`` returns it).

    Reuse protocol: the builder calls ``acquire()`` before filling the
    pool for a new chunk; the consumer calls ``release(event)`` once it has
    enqueued every copy out of the pool, with a CUDA event recorded after
    them (None when the copies were synchronous).  ``acquire`` raises if
    the pool was never released, which the engine's slot count rules out.
    """

    def __init__(self, *, pin: bool = False):
        self._pin = pin
        self._bufs: Dict[str, Tuple[np.ndarray, torch.Tensor]] = {}
        self._fence = None
        self._held = False
        self.hits = 0       # takes served from an existing buffer
        self.misses = 0     # takes that had to allocate

    def take(self, name: str, shape, dtype) -> np.ndarray:
        shape, dtype = tuple(shape), np.dtype(dtype)
        hit = self._bufs.get(name)
        if hit is None or hit[0].shape != shape or hit[0].dtype != dtype:
            t = torch.from_numpy(np.empty(0, dtype)).new_empty(
                shape, pin_memory=self._pin)
            hit = (t.numpy(), t)
            self._bufs[name] = hit
            self.misses += 1
        else:
            self.hits += 1
        return hit[0]

    def tensor(self, name: str) -> torch.Tensor:
        """The (pinned) tensor behind ``take(name, ...)``."""
        return self._bufs[name][1]

    def acquire(self) -> None:
        """Builder side: wait until the last copies out of the pool have
        run, then mark it in use."""
        if self._held:
            raise RuntimeError("StagingPool refilled before its previous "
                               "chunk was released")
        if self._fence is not None:
            self._fence.synchronize()
            self._fence = None
        self._held = True

    def release(self, event=None) -> None:
        """Consumer side: every copy out of the pool is enqueued; ``event``
        (a recorded ``torch.cuda.Event`` or None) completes after them."""
        self._fence = event
        self._held = False


class WritebackLane:
    """Single-worker serialized write-back queue with a completion counter.

    ``submit(fn)`` enqueues a thunk; one daemon worker runs them strictly
    in submission order.  ``wait_done(n)`` blocks the calling thread until
    at least ``n`` thunks completed and returns False instead of blocking
    forever once ``close()`` has been called.  ``stall_s`` accumulates the
    producer time spent in ``wait_done``.  A thunk's exception is kept
    (the worker keeps counting, so waiters never deadlock) and re-raised
    at the next ``wait_done`` / ``flush``; ``close()`` still runs the
    queued thunks before the worker retires.
    """

    def __init__(self, *, name: str = "engine-writeback", runlog=None):
        self._runlog = as_runlog(runlog)
        self._q: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._done = 0
        self._submitted = 0
        self._stop = False
        self._closed = False
        self.error = None
        self.stall_s = 0.0
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def submitted(self) -> int:
        return self._submitted

    @property
    def done(self) -> int:
        with self._cv:
            return self._done

    def submit(self, fn: Callable) -> None:
        self._submitted += 1
        self._q.put(fn)

    def _worker(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as e:   # surfaced at the next wait/flush
                with self._cv:
                    if self.error is None:
                        self.error = e
            finally:
                with self._cv:
                    self._done += 1
                    self._cv.notify_all()

    def _raise_error(self):
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def wait_done(self, n: int) -> bool:
        """Block until ``n`` submitted thunks completed; False if the lane
        was closed first (callers abort their work)."""
        t0 = time.perf_counter()
        with self._cv:
            while self._done < n and not self._stop:
                self._cv.wait(0.05)
            ok = self._done >= n
        self.stall_s += time.perf_counter() - t0
        self._raise_error()
        return ok

    def flush(self) -> None:
        """Wait for everything submitted so far to complete."""
        self.wait_done(self._submitted)

    def close(self) -> None:
        """Run the queued thunks, then retire the worker (idempotent,
        never raises: shutdown runs from ``finally`` blocks; an error
        nobody saw becomes a run-log warning)."""
        if self._closed:
            return
        self._closed = True
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._q.put(None)
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            self._runlog.warning("writeback.join_timeout")
        if self.error is not None:
            self._runlog.warning("writeback.error", error=repr(self.error))


class HostPrefetcher:
    """Iterate ``(r0, r1, build_chunk(r0, r1))`` over ``schedule``.

    With ``enabled=False`` the chunks are built synchronously on the
    consumer thread (same iteration contract, no overlap).  A builder
    exception is re-raised at the consuming ``__iter__``; ``close()``
    unblocks and retires the worker if the consumer stops early.
    ``wait_s`` accumulates the consumer's time blocked on staging.
    """

    def __init__(self, build_chunk: Callable,
                 schedule: Iterable[Tuple[int, int]], *, depth: int = 2,
                 enabled: bool = True, runlog=None):
        self._runlog = as_runlog(runlog)
        self._build = build_chunk
        self._schedule = list(schedule)
        self._enabled = enabled
        self.wait_s = 0.0
        self.error = None
        self._closed = False
        if enabled:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._worker, name="engine-prefetch", daemon=True)
            self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for r0, r1 in self._schedule:
                if self._stop.is_set():
                    return
                # the span runs on THIS thread (the run log's nesting is
                # per thread)
                with self._runlog.span("prefetch.stage", r0=r0, r1=r1):
                    staged = self._build(r0, r1)
                if not self._put((r0, r1, staged)):
                    return
            self._put(None)
        except BaseException as e:  # surfaced at the consumer
            if not self._put(e):
                self.error = e

    def __iter__(self) -> Iterator:
        if not self._enabled:
            for r0, r1 in self._schedule:
                t0 = time.perf_counter()
                with self._runlog.span("prefetch.stage", r0=r0, r1=r1):
                    staged = self._build(r0, r1)
                self.wait_s += time.perf_counter() - t0
                yield r0, r1, staged
            return
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.wait_s += time.perf_counter() - t0
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def _drain_queue(self):
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, BaseException) and self.error is None:
                    self.error = item
        except queue.Empty:
            pass

    def close(self):
        """Stop the worker and drop any staged chunks (idempotent, never
        raises: an error of ``build_chunk`` the consumer never saw becomes
        a run-log warning)."""
        if not self._enabled or self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain_queue()
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            self._runlog.warning("prefetch.join_timeout")
        self._drain_queue()
        if self.error is not None:
            self._runlog.warning("prefetch.error", error=repr(self.error))
