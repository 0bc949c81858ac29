"""FLOPs, HBM bytes and collective bytes of an op record (the port's
counterpart of ``repro/roofline/hlo.py``).

The JAX package parses the scheduled HLO of a compiled step and rolls its
ops' costs up through the call graph, scaling loop bodies by their trip
counts.  The port reads an op record
(:class:`repro_torch.analysis.records.OpRecord`): one entry per op that
ran, so trip counts are already in it, and the shapes are this rank's.
JAX's per-op rules map onto the record's ops as follows:

* ``dot`` (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``,
  ``linear``, ``mv``, ``dot``): FLOPs = 2 * prod(result) * contraction;
  bytes = operands + result;
* ``convolution`` (``aten.convolution`` and ``convolution_backward``):
  FLOPs as JAX's ``_conv_flops``, 2 * prod(result) * kernel elements / the
  output channels, for each result the backward computes; bytes =
  operands + results;
* custom-call (``kernel:*``, a hand-written kernel's call): no FLOPs, as
  JAX counts a Pallas call; bytes = operands + results;
* slice and gather (``index_select``, ``gather``, ``slice``, ``narrow``,
  ``index``): bytes = 2 x the result (the slice read and written, not the
  whole source);
* dynamic-update-slice and scatter (``index_copy_``, ``scatter``,
  ``index_put_``, ...): bytes = 2 x the update;
* views (``view``, ``t``, ``expand``, ``permute``, ...) move nothing and
  cost nothing; ``empty`` allocates without writing and costs nothing;
* collectives (``c10d`` ops): bytes = the payload a rank moves, by kind
  (all-reduce, all-gather, reduce-scatter, all-to-all, broadcast,
  collective-permute).

**Elementwise ops.**  JAX ignores elementwise ops outside fusions because
XLA fuses them, and counts each fusion's operands + result.  The port
runs eagerly, so each elementwise aten op is its own kernel: it counts
its operands + result, as a fusion of one op (an in-place op reads and
writes its destination; a ``copy_`` / ``fill_`` only writes it; a
broadcast operand is read once).  Reductions, sorts and the remaining
movement ops (JAX's ``_MOVE_OPS``) count the same way.

A kernel call is counted by the tensors it reads and writes, not by what
implements it, so a cost read from this model stays fixed when a kernel
is redesigned, and a record costs the same on the CPU, on ``meta`` and on
the card.

JAX's ``entry_io_aliases`` / ``entry_param_shapes`` (reading a compiled
module's input/output aliasing) have no counterpart: the analyzer's
donation pass reads the carried buffers' addresses and versions instead.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["COLLECTIVE_OPS", "Cost", "op_cost", "analyze_record",
           "collective_bytes", "collective_op_counts", "collective_summary",
           "flops_breakdown"]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "broadcast", "collective-permute")

# dot ops: the argument whose last dimension is contracted
_DOT_LHS = {"aten.mm": "self", "aten.bmm": "self", "aten.addmm": "mat1",
            "aten.baddbmm": "batch1", "aten.matmul": "self",
            "aten.linear": "input", "aten.mv": "self", "aten.addmv": "mat",
            "aten.dot": "self", "aten.vdot": "self"}

_GATHER = frozenset(("aten.index_select", "aten.gather", "aten.slice",
                     "aten.narrow", "aten.index"))

# scatter ops: the argument holding the update
_SCATTER = {"aten.index_copy_": "source", "aten.index_copy": "source",
            "aten.index_add_": "source", "aten.index_add": "source",
            "aten.scatter": "src", "aten.scatter_": "src",
            "aten.scatter_add": "src", "aten.scatter_add_": "src",
            "aten.scatter_reduce": "src", "aten.scatter_reduce_": "src",
            "aten.index_put": "values", "aten.index_put_": "values",
            "aten._index_put_impl_": "values",
            "aten.slice_scatter": "src", "aten.select_scatter": "src",
            "aten.diagonal_scatter": "src", "aten.masked_scatter_": "source"}

# views the schema does not mark as aliasing
_VIEWS = frozenset(("aten._unsafe_view", "aten.alias", "aten.detach",
                    "aten.lift_fresh", "aten._reshape_alias"))

_ALLOCATE = frozenset(("aten.empty", "aten.empty_like", "aten.empty_strided",
                       "aten.new_empty", "aten.new_empty_strided"))

# in-place ops that write their destination without reading it
_WRITE_ONLY = frozenset(("aten.copy_", "aten.fill_", "aten.zero_",
                         "aten.uniform_", "aten.normal_", "aten.random_",
                         "aten.bernoulli_", "aten.exponential_",
                         "aten.resize_", "aten.set_"))


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0.0) + v
        return self

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _io_bytes(e) -> float:
    """Operands + results: an argument written in place counts as a result
    (and as an operand too where the op reads it)."""
    out = sum(t.nbytes for t in e.outputs if t is not None)
    read_written = e.name not in _WRITE_ONLY
    inp = sum(t.nbytes for n, t in e.inputs
              if n not in e.mutated or read_written)
    return float(inp + out)


def _dot_flops(e) -> float:
    lhs = e.arg(_DOT_LHS[e.name])
    res = [t for t in e.outputs if t is not None]
    if not lhs or not res or not lhs[0].shape:
        return 0.0
    return 2.0 * _numel(res[0].shape) * lhs[0].shape[-1]


def _kernel_elems(weight, transposed: bool) -> int:
    """Kernel elements feeding one output element: the weight's elements
    over its output channels (JAX's ``kernel_elems / C_out``)."""
    c_out = weight.shape[1] if transposed else weight.shape[0]
    return _numel(weight.shape) // max(int(c_out), 1)


def _conv_flops(e) -> float:
    w = e.arg("weight")
    if not w or not w[0].shape:
        return 0.0
    transposed = bool(e.extra.get("transposed", False))
    if e.name == "aten.convolution":
        res = [t for t in e.outputs if t is not None]
        return 2.0 * _numel(res[0].shape) * _kernel_elems(w[0], transposed) \
            if res else 0.0
    # convolution_backward: grad_input as a convolution whose result has
    # the input's shape and whose kernel maps each input element to C_out
    # outputs; grad_weight as one whose result has the weight's shape
    # (the forward's FLOPs)
    go, inp = e.arg("grad_output"), e.arg("input")
    mask = list(e.extra.get("output_mask", (True, True, True)))
    groups = int(e.extra.get("groups", 1))
    flops = 0.0
    if mask[0] and inp:
        # outputs one input element feeds: C_out / groups x the window
        n_w = _numel(w[0].shape)
        per_in = (n_w // max(int(w[0].shape[0]), 1) if transposed
                  else n_w // max(int(w[0].shape[1]) * groups, 1))
        flops += 2.0 * _numel(inp[0].shape) * per_in
    if mask[1] and go:
        flops += 2.0 * _numel(go[0].shape) * _kernel_elems(w[0], transposed)
    return flops


def op_cost(e) -> Cost:
    """The cost of one record entry under the rules of the module
    docstring."""
    if e.collective is not None:
        payload = float(sum(t.nbytes for t in e.payload))
        return Cost(0.0, payload, {e.collective: payload},
                    {e.collective: float(len(e.payload))})
    if e.name.startswith("c10d."):
        return Cost()
    if e.is_kernel:
        return Cost(0.0, _io_bytes(e))
    if e.name in _DOT_LHS:
        return Cost(_dot_flops(e), _io_bytes(e))
    if e.name in ("aten.convolution", "aten.convolution_backward"):
        return Cost(_conv_flops(e), _io_bytes(e))
    if e.name in _GATHER:
        return Cost(0.0, 2.0 * sum(t.nbytes for t in e.outputs
                                   if t is not None))
    if e.name in _SCATTER:
        upd = e.arg(_SCATTER[e.name])
        if not upd:         # a scalar value: the indexed elements
            idx = e.arg("index") or e.arg("indices")
            dst = e.arg("self")
            itemsize = (dst[0].nbytes // max(_numel(dst[0].shape), 1)
                        if dst else 4)
            return Cost(0.0, 2.0 * sum(t.numel for t in idx) * itemsize)
        return Cost(0.0, 2.0 * sum(t.nbytes for t in upd))
    if e.view or e.name in _VIEWS or e.name in _ALLOCATE:
        return Cost()
    return Cost(0.0, _io_bytes(e))


def analyze_record(record) -> Cost:
    """The total cost of a record (JAX's ``analyze_entry``)."""
    total = Cost()
    for e in record:
        total += op_cost(e)
    return total


# Simple interfaces ---------------------------------------------------------

def collective_bytes(record) -> Dict[str, int]:
    return {k: int(v) for k, v in analyze_record(record).coll_bytes.items()}


def collective_op_counts(record) -> Dict[str, int]:
    return {k: int(v) for k, v in analyze_record(record).coll_counts.items()}


def collective_summary(record) -> Dict[str, Tuple[int, int]]:
    """``{collective: (op_count, payload_bytes)}`` of a record in one
    walk."""
    cost = analyze_record(record)
    return {k: (int(cost.coll_counts.get(k, 0)), int(v))
            for k, v in cost.coll_bytes.items()}


def flops_breakdown(record, top: int = 25) -> List[Tuple[str, float, float]]:
    """``(op name, flops, bytes)`` summed over the record's entries of each
    name, the largest FLOPs first: a poor man's profile of the step."""
    rows = defaultdict(lambda: [0.0, 0.0])
    for e in record:
        c = op_cost(e)
        if c.flops or c.bytes:
            rows[e.name][0] += c.flops
            rows[e.name][1] += c.bytes
    out = sorted(((n, f, b) for n, (f, b) in rows.items()),
                 key=lambda r: (-r[1], -r[2]))
    return out[:top]
