"""``repro_torch.control``: adaptive compression controllers inside the
superstep (port of ``repro.control``).

A plugin registry of controllers whose state is carried through the
engine's chunk, reads the round's on-device telemetry signals
(``repro_torch.obs``) and selects the next round's effective compression
level on a discrete codec ladder, with no host round-trip.  See
``repro_torch.control.controller`` for the protocol and the built-ins
(``static`` / ``ef_ratio`` / ``bytes_budget`` / ``loss_trend``).
"""
from repro_torch.control.controller import (  # noqa: F401
    LADDER_CODECS, BytesBudgetController, Controller, EFRatioController,
    LadderSpec, LossTrendController, StaticController, ladder_kind,
    ladder_values, make_controller, register_controller,
    registered_controllers)
