"""Kernel calls as the op recorder sees them.

The hand-written kernels launch through ``ctypes`` (``kernels/build.py``),
which the torch dispatcher never sees.  So each wrapper that chooses a
kernel or its plain version is decorated with :func:`kernel_entry`: while
an op recorder (``repro_torch.analysis.records.OpRecorder``) is active,
one call of the wrapper becomes one record entry ``kernel:<name>`` with
the tensors it reads and writes, and the plain version's own aten ops
inside that call are not recorded again.  A call's record, and its cost,
are then the same on the CPU, on ``meta`` and on the card.  With no
recorder active the decorator adds one list lookup a call.

Each entry carries the launches the call makes on the card, by the name
of the ``launches`` counter they tick (:data:`COUNTERS`), so a record's
kernel entries can be held against the counters' deltas.

:func:`runs_plain` is the wrappers' one device test: a tensor on the CPU,
or on ``meta`` (shapes only, nothing computed), takes the plain version;
a tensor on the card takes the kernel.
"""
from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, List, Optional

__all__ = ["kernel_entry", "runs_plain", "counters", "launch_counts",
           "COUNTERS"]

# recorders entered and not yet left, innermost last
_RECORDERS: List = []

# counter name -> (kernel module, wrapper whose ``launches`` it is)
COUNTERS = {
    "gram_sum": ("mk_mmd", "gram_sum_cuda"),
    "mk_mmd2": ("mk_mmd", "mk_mmd2_cuda"),
    "mk_mmd2_grad": ("mk_mmd", "mk_mmd2_grad_cuda"),
    "fusion_conv": ("fusion_conv", "fusion_conv_cuda"),
    "quant_pack": ("compress_pack", "quant_pack_cuda"),
    "quant_unpack": ("compress_pack", "quant_unpack_cuda"),
    "topk_select": ("compress_pack", "topk_select_cuda"),
    "ef_gather": ("compress_pack", "ef_gather_cuda"),
    "ef_scatter": ("compress_pack", "ef_scatter_cuda"),
    "flash_fwd": ("flash_attn", "flash_fwd_cuda"),
    "flash_bwd_dq": ("flash_attn", "flash_bwd_dq_cuda"),
    "flash_bwd_dkv": ("flash_attn", "flash_bwd_dkv_cuda"),
    "flash_decode": ("decode_attn", "flash_decode_cuda"),
}


def counters() -> Dict[str, Callable]:
    """Counter name -> the CUDA wrapper holding its ``launches``."""
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), fn)
        for name, (mod, fn) in COUNTERS.items()}


def launch_counts() -> Dict[str, int]:
    """Every counter's ``launches`` now."""
    return {name: fn.launches for name, fn in counters().items()}


def runs_plain(t) -> bool:
    """Whether a wrapper given ``t`` takes the plain version: ``t`` lies on
    the CPU or on ``meta``.  On the card it launches the kernel (or
    raises)."""
    return t.device.type in ("cpu", "meta")


def kernel_entry(name: str, launches: Optional[Callable] = None):
    """Decorator: under an active recorder, one call of the wrapper is one
    ``kernel:<name>`` entry.  ``launches(*args, **kwargs)`` gives the
    call's launches by counter name (default ``{name: 1}``)."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _RECORDERS:
                return fn(*args, **kwargs)
            counts = (launches(*args, **kwargs) if launches is not None
                      else {name: 1})
            return _RECORDERS[-1].kernel_call(name, counts, fn, args, kwargs)
        return call
    return deco
