"""``repro_torch.obs`` — observability for the federated engine (port of
``repro.obs``).

Three layers, all off by default and bit-invisible when off:

* :mod:`repro_torch.obs.telemetry` — on-device taps whose per-round
  signals ride the round's metrics (no extra host sync; on the card they
  run inside the captured chunk);
* :mod:`repro_torch.obs.runlog` — host-side structured span/event/counter
  sink streaming JSONL (:class:`RunLog`), with a zero-allocation disabled
  path;
* :mod:`repro_torch.obs.report` — fold a run's RunLog + CommLog records
  into a round-time breakdown and telemetry trend report.

Nothing here imports the rest of ``repro_torch`` but its tree helpers, so
``repro_torch.fl.comm`` and ``repro_torch.engine`` can both use it without
cycles.
"""
from repro_torch.obs.report import build_report, render
from repro_torch.obs.runlog import (NULL_RUNLOG, NullRunLog, RunLog,
                                    as_runlog, json_safe)
from repro_torch.obs.telemetry import (TELEMETRY_PREFIX, ClientTapCtx,
                                       RoundTapCtx, Telemetry, TelemetryTap,
                                       make_telemetry, register_tap,
                                       registered_taps)

__all__ = [
    "RunLog", "NullRunLog", "NULL_RUNLOG", "as_runlog", "json_safe",
    "Telemetry", "TelemetryTap", "ClientTapCtx", "RoundTapCtx",
    "make_telemetry", "register_tap", "registered_taps", "TELEMETRY_PREFIX",
    "build_report", "render",
]
