"""The JAX cost model's module, by its name (``repro/roofline/hlo.py``).

The port has no HLO: its cost model reads op records, and lives in
:mod:`repro_torch.roofline.cost`.  This module keeps the JAX module's name
and the names of its functions that have a counterpart
(``analyze_entry`` is :func:`~repro_torch.roofline.cost.analyze_record`),
so code written against ``repro.roofline.hlo`` finds them here.  JAX's
``entry_io_aliases`` / ``entry_param_shapes`` have none: the analyzer's
donation pass reads the carried buffers' addresses and versions.
"""
from repro_torch.roofline.cost import (  # noqa: F401
    COLLECTIVE_OPS, Cost, analyze_record as analyze_entry, collective_bytes,
    collective_op_counts, collective_summary, flops_breakdown)
