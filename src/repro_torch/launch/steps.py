"""The training step of the LM launcher (port of ``repro/launch/steps.py``:
``build_train_step`` on one device, without shardings)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FLConfig, InputShape
from repro_torch.core.rounds import make_round_fn
from repro_torch.launch.specs import input_specs
from repro_torch.models.registry import make_bundle


def build_train_step(cfg: ArchConfig, fl: FLConfig, shape: InputShape,
                     dtype=torch.float32):
    """One FL round (paper Alg. 1/2) of ``cfg``'s bundle in its
    ``fl_mode``.  Returns (round_fn, batch specs): ``round_fn(state,
    batch, n_examples, lr) -> (state, {"local_loss"})`` runs on the
    state's device; the specs are :func:`launch.specs.input_specs`."""
    round_fn = make_round_fn(make_bundle(cfg, dtype), fl, cfg.fl_mode)
    return round_fn, input_specs(cfg, shape)
