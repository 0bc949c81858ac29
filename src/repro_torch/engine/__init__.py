"""Evaluation helpers of the port (``repro.engine.evaljit``); the
device-resident engine itself is a later slice."""
from repro_torch.engine.evaljit import make_eval_fn, pad_eval_batch

__all__ = ["make_eval_fn", "pad_eval_batch"]
