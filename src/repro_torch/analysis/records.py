"""Op records: the one walk every lowered pass reads (the port's
counterpart of ``repro/analysis/jaxprs.py``).

The JAX package traces a superstep to a jaxpr and walks its equations.
The port has no trace: it runs the chunk body once under
:class:`OpRecorder`, a ``TorchDispatchMode``, and keeps one
:class:`OpEntry` per op that ran, with the dtype, shape and device of
every tensor in and out:

* each aten op (``aten.mm``, ``aten.copy_``, ...) below autograd, as the
  device executes it;
* each ``c10d`` op (``c10d.allreduce_`` for ``dist.all_reduce``, ...),
  with the payload it moves;
* each call of a kernel wrapper (``repro_torch.kernels.calls``) as ONE
  entry ``kernel:<name>`` with the tensors it reads and writes and the
  launches it makes on the card; the plain version's own aten ops inside
  that call are not recorded again, so a record is the same on the CPU,
  on ``meta`` and on the card.

A record is of executed ops, so it is trip-weighted by nature: a round
body run K times appears K times.  JAX's ``round_body`` (finding the
round scan inside the superstep) has no counterpart; its job, telling the
round body apart from what surrounds it, is done by recording each point
at K and at K + 1 rounds (:func:`per_round`).

The recorder also keeps the high-water mark of live tensor bytes that
recorded ops allocated (a kernel call's outputs, not its plain version's
temporaries).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import calls

__all__ = ["COLLECTIVE_PRIMITIVES", "HOST_SYNC_PRIMITIVES", "ALL_REDUCE",
           "TensorInfo", "OpEntry", "OpRecord", "OpRecorder",
           "count_primitives", "count_collectives", "find_primitives",
           "collect_avals", "collective_execution_model", "kernel_launches",
           "is_host_sync", "per_round", "storage_key"]

# c10d op -> (collective kind, position of its payload argument).  JAX's
# ``psum`` is the port's all-reduce, the only collective the engine may
# issue; the rest are listed so a stray all-gather trips the same counts
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
    "reduce_": ("reduce", 0),
    "gather_": ("gather", 1),
    "scatter_": ("scatter", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "recv_any_source_": ("collective-permute", 0),
}
COLLECTIVE_PRIMITIVES: Tuple[str, ...] = tuple(f"c10d.{n}"
                                               for n in _COLLECTIVES)
ALL_REDUCE = "c10d.allreduce_"

# ops that make the host wait for the device: ``.item()`` / ``float(t)`` /
# ``bool(t)`` (``_local_scalar_dense``), data-dependent shapes, and (see
# :func:`is_host_sync`) a copy from the device to the host
HOST_SYNC_PRIMITIVES: Tuple[str, ...] = (
    "aten._local_scalar_dense", "aten.nonzero", "aten.equal",
    "aten.is_nonzero")

# scalar arguments the cost model reads
_EXTRA_ARGS = ("transposed", "groups", "output_mask")

# device types that hold no data the host would wait for
_HOST_SIDE = ("cpu", "meta")


@dataclass(frozen=True)
class TensorInfo:
    """A tensor as an op saw it.  ``nbytes`` counts the elements the op
    touches: a broadcast (stride-0) dimension is read once.  ``storage``
    identifies the memory it lies in within one run (not compared: it
    differs from run to run)."""
    dtype: str
    shape: Tuple[int, ...]
    device: str
    nbytes: int
    storage: int = field(default=0, compare=False)

    @staticmethod
    def of(t: torch.Tensor) -> "TensorInfo":
        n = t.element_size()
        try:
            for size, stride in zip(t.shape, t.stride()):
                if stride != 0:
                    n *= int(size)
        except RuntimeError:        # no strides (sparse, nested): all of it
            n = t.element_size() * t.numel()
        return TensorInfo(str(t.dtype).replace("torch.", ""),
                          tuple(int(s) for s in t.shape), t.device.type,
                          int(n), storage_key(t) or 0)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass
class OpEntry:
    """One recorded op.  ``inputs``: (argument name, tensor) of every
    tensor argument; ``outputs``: the tensors it returned (None where an
    optional result was not computed); ``mutated``: the names of the
    arguments it wrote in place; ``payload`` / ``collective``: what a
    ``c10d`` op moves and its kind; ``launches``: a kernel call's launches
    on the card, by counter name."""
    name: str
    inputs: Tuple[Tuple[str, TensorInfo], ...] = ()
    outputs: Tuple[Optional[TensorInfo], ...] = ()
    mutated: Tuple[str, ...] = ()
    view: bool = False
    extra: Dict = field(default_factory=dict)
    payload: Tuple[TensorInfo, ...] = ()
    collective: Optional[str] = None
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def is_kernel(self) -> bool:
        return self.name.startswith("kernel:")

    def arg(self, name: str) -> List[TensorInfo]:
        """The tensors of argument ``name``."""
        return [t for n, t in self.inputs if n == name]

    def tensors(self) -> Iterator[TensorInfo]:
        """Every tensor in and out."""
        for _, t in self.inputs:
            yield t
        for t in self.outputs:
            if t is not None:
                yield t


@dataclass
class OpRecord:
    """The entries of one recorded run, in order, and the high-water mark
    of live bytes its ops allocated."""
    entries: List[OpEntry] = field(default_factory=list)
    peak_bytes: int = 0

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)


def _tensors(v) -> List[torch.Tensor]:
    """The tensors in ``v``: a tensor, or nested lists / tuples of them."""
    leaves = tree_flatten(v)[0] if isinstance(v, (list, tuple)) else [v]
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _named_tensors(schema, args, kwargs):
    """(argument name, tensor) of every tensor argument, lists flattened,
    and the names of the arguments the op writes."""
    out, mutated = [], []
    for i, a in enumerate(schema.arguments):
        if i < len(args):
            found = _tensors(args[i])
        elif a.name in kwargs:
            found = _tensors(kwargs[a.name])
        else:
            continue
        out += [(a.name, x) for x in found]
        if found and a.alias_info is not None and a.alias_info.is_write:
            mutated.append(a.name)
    return out, mutated


def _storage(t):
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None, None
    return st._cdata, st


def storage_key(t: torch.Tensor) -> Optional[int]:
    """An id of the memory ``t`` lies in, the same for all its views while
    it lives (None for a tensor without storage)."""
    return _storage(t)[0]


class OpRecorder(TorchDispatchMode):
    """Records every op run inside ``with OpRecorder() as rec:`` into
    ``rec.record`` (an :class:`OpRecord`).  Entering it also makes it the
    active recorder of ``repro_torch.kernels.calls``, so kernel wrappers
    record themselves as one entry each."""

    def __init__(self):
        super().__init__()
        self.record = OpRecord()
        self._suppress = 0
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}

    def __enter__(self):
        calls._RECORDERS.append(self)
        try:
            return super().__enter__()
        except BaseException:
            calls._RECORDERS.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            calls._RECORDERS.remove(self)

    # -- live bytes --------------------------------------------------------
    def _track(self, outputs, inputs):
        """Add the storages ``outputs`` allocated (not an input's: a view
        or an in-place result) and raise the high-water mark."""
        seen = {storage_key(t) for t in inputs}
        for t in outputs:
            key, st = _storage(t)
            if key is None or key in seen or key in self._live:
                continue
            self._live[key] = (StorageWeakRef(st), int(st.nbytes()))
        live = 0
        expired = torch.UntypedStorage._expired   # StorageWeakRef.expired
        for key in list(self._live):
            ref, n = self._live[key]
            if expired(ref.cdata):
                del self._live[key]
            else:
                live += n
        self.record.peak_bytes = max(self.record.peak_bytes, live)

    # -- entries -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suppress:          # a kernel call's plain version
            return func(*args, **kwargs)
        schema = func._schema
        name = schema.name.replace("::", ".")
        named, mutated = _named_tensors(schema, args, kwargs)
        entry = OpEntry(
            name, inputs=tuple((n, TensorInfo.of(t)) for n, t in named),
            mutated=tuple(mutated),
            view=any(r.alias_info is not None and not r.alias_info.is_write
                     for r in schema.returns),
            extra={a.name: v for a, v in zip(schema.arguments, args)
                   if a.name in _EXTRA_ARGS})
        op = schema.name.split("::")[-1]
        if func.namespace == "c10d" and op in _COLLECTIVES:
            kind, pos = _COLLECTIVES[op]
            entry.collective = kind
            entry.payload = tuple(TensorInfo.of(t) for t in _tensors(
                args[pos] if pos < len(args) else ()))
        # recorded before it runs: an op that fails (a sync refused inside
        # a graph capture) still shows in the record
        self.record.entries.append(entry)
        out = func(*args, **kwargs)
        flat = []           # None keeps the place of an uncomputed result
        for r in (out if isinstance(out, (list, tuple)) else [out]):
            flat += [None] if r is None else _tensors(r)
        entry.outputs = tuple(None if t is None else TensorInfo.of(t)
                              for t in flat)
        if not entry.view:
            self._track([t for t in flat if t is not None],
                        [t for _, t in named])
        return out

    def kernel_call(self, name, launches, fn, args, kwargs):
        """One ``kernel:<name>`` entry for a wrapper call; the plain
        version's ops inside it are not recorded."""
        if self._suppress:
            return fn(*args, **kwargs)
        named = [(f"arg{i}", x) for i, a in enumerate(args)
                 for x in _tensors(a)]
        named += [(k, x) for k, a in kwargs.items() for x in _tensors(a)]
        entry = OpEntry(f"kernel:{name}",
                        inputs=tuple((n, TensorInfo.of(t))
                                     for n, t in named),
                        launches=dict(launches))
        self.record.entries.append(entry)
        self._suppress += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._suppress -= 1
        flat = _tensors(out)
        entry.outputs = tuple(TensorInfo.of(t) for t in flat)
        self._track(flat, [t for _, t in named])
        return out


# ---------------------------------------------------------------------------
# Walks over a record (JAX's jaxpr walks, by their names)
# ---------------------------------------------------------------------------

def count_primitives(record, names: Sequence[str]) -> int:
    """Number of entries whose name is in ``names`` (executions: a round
    run K times counts K times)."""
    names = frozenset(names)
    return sum(1 for e in record if e.name in names)


def count_collectives(record, names: Optional[Sequence[str]] = None) -> int:
    """Collective entries in ``record``: with the default ``names`` every
    op of :data:`COLLECTIVE_PRIMITIVES` counts, so "exactly K + 1" also
    proves no other collective crept in.  ``names=(ALL_REDUCE,)`` counts
    all-reduces alone."""
    return count_primitives(record, COLLECTIVE_PRIMITIVES
                            if names is None else names)


def find_primitives(record, names: Sequence[str]) -> List[OpEntry]:
    """The entries whose name is in ``names``."""
    names = frozenset(names)
    return [e for e in record if e.name in names]


def collect_avals(record) -> Iterator[TensorInfo]:
    """Every tensor flowing through ``record``: each entry's inputs and
    outputs."""
    for e in record:
        yield from e.tensors()


def collective_execution_model(record, names: Optional[Sequence[str]] = None
                               ) -> Tuple[int, int]:
    """``(op_count, payload_bytes)`` of the record's collectives: each
    collective entry contributes one op and its bytes per payload tensor
    (the record is of executed ops, so it is trip-weighted already)."""
    names = frozenset(COLLECTIVE_PRIMITIVES if names is None else names)
    ops = nbytes = 0
    for e in record:
        if e.name in names:
            ops += len(e.payload)
            nbytes += sum(t.nbytes for t in e.payload)
    return ops, nbytes


def kernel_launches(record) -> Dict[str, int]:
    """The launches the record's kernel calls make on the card, by
    counter name (``repro_torch.kernels.calls.COUNTERS``)."""
    out = Counter()
    for e in record:
        out.update(e.launches)
    return {k: v for k, v in out.items() if v}


def is_host_sync(entry: OpEntry) -> bool:
    """Whether the entry makes the host wait for the device: an op of
    :data:`HOST_SYNC_PRIMITIVES`, or a ``_to_copy`` / ``copy_`` whose
    destination is on the CPU and whose source is not."""
    if entry.name in HOST_SYNC_PRIMITIVES:
        return True
    if entry.name == "aten._to_copy":
        src = entry.arg("self")
        return bool(src and entry.outputs and entry.outputs[0] is not None
                    and entry.outputs[0].device == "cpu"
                    and src[0].device not in _HOST_SIDE)
    if entry.name == "aten.copy_":
        dst, src = entry.arg("self"), entry.arg("src")
        return bool(dst and src and dst[0].device == "cpu"
                    and src[0].device not in _HOST_SIDE)
    return False


def per_round(count_k: int, count_k1: int, k: int) -> Tuple[int, int]:
    """``(per round, outside the rounds)`` of a count taken at K and at
    K + 1 rounds: c(K+1) - c(K), and c(K) - K * per round."""
    each = count_k1 - count_k
    return each, count_k - k * each
