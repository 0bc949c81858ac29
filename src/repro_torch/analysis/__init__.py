"""Static invariant analyzer for the engine's chunks (port of
``repro/analysis``).

``repro_torch.analysis`` checks the engine's structural contracts — one
all-reduce per fused round, no host sync inside a captured chunk, f32 end
to end, carried state updated in place, collective bytes equal to the
bytes model — by recording the ops of one chunk per config point
(:mod:`repro_torch.analysis.records`) instead of walking jaxprs and HLO.
Passes live in a registry (``register_pass`` / ``make_pass``) like the
port's codec/algorithm/controller plugins; ``python -m
repro_torch.analysis`` runs a pass set over the config matrix and exits
non-zero on violation.
"""
from repro_torch.analysis.records import (ALL_REDUCE,  # noqa: F401
                                          COLLECTIVE_PRIMITIVES,
                                          HOST_SYNC_PRIMITIVES, OpEntry,
                                          OpRecord, OpRecorder, TensorInfo,
                                          collect_avals,
                                          collective_execution_model,
                                          count_collectives,
                                          count_primitives,
                                          find_primitives, is_host_sync,
                                          kernel_launches, per_round)
from repro_torch.analysis.registry import (AnalysisFailure,  # noqa: F401
                                           AnalysisPass, Finding,
                                           make_pass, register_pass,
                                           registered_passes)
from repro_torch.analysis.lower import (CODEC_CASES,  # noqa: F401
                                        LoweredSuperstep, Lowering,
                                        SuperstepSpec, analysis_bundle,
                                        default_matrix, default_shard,
                                        fl_for, lower_superstep)
from repro_torch.analysis import passes as _passes  # noqa: F401 (registers)
from repro_torch.analysis import lint as _lint      # noqa: F401 (registers)
from repro_torch.analysis.runner import Report, run_analysis  # noqa: F401
