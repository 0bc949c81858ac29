"""The JAX analyzer's walk module, by its name (``repro/analysis/
jaxprs.py``).

The port has no jaxprs: its passes walk op records, and the walk lives in
:mod:`repro_torch.analysis.records`.  This module keeps the JAX module's
name and the names of its functions that have a counterpart, so code
written against ``repro.analysis.jaxprs`` finds them here.  JAX's
``iter_eqns``, ``subjaxprs``, ``scan_bodies`` and ``round_body`` have
none: a record is a flat list of executed ops (see
``records.per_round``).
"""
from repro_torch.analysis.records import (  # noqa: F401
    COLLECTIVE_PRIMITIVES, HOST_SYNC_PRIMITIVES, collect_avals,
    collective_execution_model, count_collectives, count_primitives,
    find_primitives)
