"""``RunLog``: structured host-side span tracing and event logging (port of
``repro/obs/runlog.py``).

The engine's host-side timeline was scattered across ad-hoc counters —
``HostPrefetcher.wait_s``, ``MetricsPump.wait_s``, a handful of
``ServerResult.stats`` entries — none of which say *when* anything
happened or how the pieces nest.  ``RunLog`` formalizes it as an
append-only stream of schema'd records:

* ``span``    — a named interval on the monotonic clock (``t0``/``dur``
  seconds since the log's origin) with an ``id`` and the enclosing span's
  ``parent`` id, tracked per thread so the prefetch worker's staging
  spans interleave correctly with the dispatch thread's chunk spans;
* ``event``   — a point-in-time marker (run start/end, non-finite metric
  warnings, checkpoint writes);
* ``counter`` — a named numeric sample (queue waits, staging-pool hits).

Records are plain dicts serialized by :func:`json_safe` (numpy scalars
and small arrays included), streamed to a JSONL file as they are emitted
when the log is constructed with a path, and always kept in memory for
:meth:`records` / :meth:`save`.  ``RunLog.load`` round-trips the file.

The disabled path is :data:`NULL_RUNLOG` — a singleton whose methods do
nothing and whose ``span`` returns one shared no-op context manager, so
instrumented code calls the same API unconditionally and a run without
observability allocates nothing per call.  ``as_runlog`` resolves the
user-facing knob (None | path | RunLog) to one of the two.

This module sits at the bottom of the import graph: stdlib, numpy and
torch only (``json_safe`` reads tensors), so ``repro_torch.fl.comm`` and
``repro_torch.engine`` can both use the serializer without cycles.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

__all__ = ["RunLog", "NullRunLog", "NULL_RUNLOG", "as_runlog", "json_safe"]


def json_safe(v: Any) -> Any:
    """One value -> something ``json.dump`` accepts.

    numpy scalars and 0-d tensors become Python numbers, small arrays
    and tensors become lists, dict/list/tuple recurse; anything else falls
    back to ``str`` rather than raising mid-run (a telemetry sink must
    never kill the run it observes).
    """
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.bool_, np.integer)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if hasattr(v, "ndim"):                      # ndarray
        arr = np.asarray(v)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return str(v)


class _Span:
    """Context manager recording one timed interval into its RunLog."""

    __slots__ = ("_log", "name", "attrs", "_t0", "_id", "_parent")

    def __init__(self, log: "RunLog", name: str, attrs: Dict):
        self._log = log
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        self._id, self._parent = self._log._push_span()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0
        self._log._pop_span()
        rec = {"kind": "span", "name": self.name, "id": self._id,
               "parent": self._parent,
               "t0": round(self._t0 - self._log._origin, 6),
               "dur": round(dur, 6)}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        rec.update({k: json_safe(v) for k, v in self.attrs.items()})
        self._log._append(rec)
        return False


class RunLog:
    """Append-only structured event sink (see module docstring).

    ``path=None`` keeps records in memory only; a path streams each
    record as one JSON line the moment it is emitted, so a crashed run
    still leaves its timeline on disk.
    """

    enabled = True

    def __init__(self, path: Optional[str] = None):
        self._origin = time.monotonic()
        self._records: List[Dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0
        self._file: Optional[io.TextIOBase] = None
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._file = open(path, "w", buffering=1)

    # -- span bookkeeping (thread-local nesting) ------------------------
    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push_span(self):
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        st = self._stack()
        parent = st[-1] if st else None
        st.append(sid)
        return sid, parent

    def _pop_span(self):
        st = self._stack()
        if st:
            st.pop()

    def _append(self, rec: Dict):
        with self._lock:
            self._records.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")

    def _now(self) -> float:
        return round(time.monotonic() - self._origin, 6)

    # -- public API -----------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        """``with runlog.span("chunk.dispatch", r0=0, r1=8): ...``"""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs):
        rec = {"kind": "event", "name": name, "t": self._now()}
        rec.update({k: json_safe(v) for k, v in attrs.items()})
        self._append(rec)

    def counter(self, name: str, value, **attrs):
        rec = {"kind": "counter", "name": name, "t": self._now(),
               "value": json_safe(value)}
        rec.update({k: json_safe(v) for k, v in attrs.items()})
        self._append(rec)

    def warning(self, name: str, **attrs):
        """An ``event`` tagged ``level="warning"`` (non-finite metrics,
        dropped work) so reports can surface it without string-matching."""
        self.event(name, level="warning", **attrs)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    def save(self, path: Optional[str] = None) -> str:
        """Write every record as JSONL; defaults to the streaming path."""
        path = path or self.path
        if not path:
            raise ValueError("RunLog.save needs a path (none bound)")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with self._lock:
            with open(path, "w") as f:
                for rec in self._records:
                    f.write(json.dumps(rec) + "\n")
        return path

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    @staticmethod
    def load(path: str) -> List[Dict]:
        """JSONL file -> list of records (inverse of save/streaming)."""
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


class _NullSpan:
    """Shared no-op context manager: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRunLog:
    """Disabled sink: same API as RunLog, every method a no-op.

    ``span`` returns ONE shared context manager instance so the
    instrumented hot loop costs a method call and nothing else — pinned
    by the zero-allocation test in ``tests/test_torch_obs.py``.
    """

    enabled = False
    path = None

    def span(self, *a, **k):
        return _NULL_SPAN

    def event(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass

    def warning(self, *a, **k):
        pass

    def records(self) -> List[Dict]:
        return []

    def close(self):
        pass


NULL_RUNLOG = NullRunLog()


def as_runlog(runlog: Union[None, str, RunLog]) -> Union[RunLog, NullRunLog]:
    """Resolve the user-facing knob: None -> the shared null sink, a path
    -> a streaming RunLog owned by the caller, a RunLog -> itself."""
    if runlog is None:
        return NULL_RUNLOG
    if isinstance(runlog, (RunLog, NullRunLog)):
        return runlog
    return RunLog(str(runlog))
