"""Configuration dataclasses (port of ``repro/configs/base.py``, the CNN
and federated-learning halves).

``FLConfig`` keeps the fields the federated training path reads, with the
same names, defaults and validation as the JAX package.  The
participation and controller fields exist so a config that asks for them
is representable; the port's server refuses those settings until they are
ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

FL_MODES = ("client_parallel", "client_sequential")

# Wire codecs, participation policies and compression controllers of the
# JAX package (literal copies of repro.configs.base's tuples).
CODEC_NAMES = ("identity", "quant", "int8", "int4", "topk", "topk_noef",
               "mask", "lowrank")
PARTICIPATION_NAMES = ("full_sync", "deadline", "buffered_async")
CONTROLLER_NAMES = ("static", "ef_ratio", "bytes_budget", "loss_trend")

# Algorithm plugins registered by repro_torch.fl.api.plugins; names
# registered at runtime are validated against the live registry lazily.
ALGORITHM_NAMES = ("fedavg", "fedmmd", "fedfusion", "fedl2")


@dataclass(frozen=True)
class CNNConfig:
    """The paper's MNIST / CIFAR CNNs (§4.1.1)."""

    name: str
    input_shape: Tuple[int, int, int]          # H, W, C
    conv_channels: Tuple[int, ...]             # per conv layer (5x5 kernels)
    pool_size: int
    pool_stride: int
    fc_units: Tuple[int, ...]
    n_classes: int = 10
    dropout: float = 0.5

    @property
    def feature_hw(self) -> Tuple[int, int]:
        h, w, _ = self.input_shape
        for _ in self.conv_channels:
            h = (h - self.pool_size) // self.pool_stride + 1
            w = (w - self.pool_size) // self.pool_stride + 1
        return h, w


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round configuration (the paper's mechanisms)."""

    algorithm: str = "fedavg"         # an ALGORITHM_NAMES / registry name
    fusion_op: str = "multi"          # conv | multi | single   (fedfusion)
    mmd_lambda: float = 0.1           # λ for L_MMD (paper §4.2)
    mmd_widths: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0)  # RBF widths
    l2_lambda: float = 0.01           # two-stream L2 baseline coefficient
    clients_per_round: int = 16       # C·K in the paper
    local_steps: int = 2              # batches per local epoch
    local_epochs: int = 1             # passes over the round's batches (E)
    cache_global_features: bool = True  # paper §3.3: compute the frozen
    # global stream's features once per round and reuse across epochs
    local_batch: int = 16             # B
    lr: float = 2e-3
    lr_decay: float = 1.0             # exponential decay per round
    momentum: float = 0.0
    ema_beta: float = 0.5             # gate EMA for multi/single aggregation
    optimizer: str = "sgd"            # sgd | adam
    uplink_codec: str = "identity"    # client -> server delta codec
    downlink_codec: str = "identity"  # server -> client broadcast codec
    topk_frac: float = 0.05           # kept fraction (topk / mask / lowrank)
    quant_bits: int = 8               # the "quant" codec's bit width
    participation: str = "full_sync"
    controller: str = "static"

    def __post_init__(self):
        if self.algorithm not in ALGORITHM_NAMES:
            from repro_torch.fl.api import registered_algorithms
            if self.algorithm not in registered_algorithms():
                raise ValueError(
                    f"unknown algorithm {self.algorithm!r}; registered: "
                    f"{registered_algorithms()}")
        if self.fusion_op not in ("conv", "multi", "single"):
            raise ValueError(f"fusion_op {self.fusion_op!r} must be 'conv', "
                             "'multi' or 'single'")
        if self.uplink_codec not in CODEC_NAMES:
            raise ValueError(f"unknown uplink_codec {self.uplink_codec!r}; "
                             f"choose from {CODEC_NAMES}")
        if self.downlink_codec not in CODEC_NAMES:
            raise ValueError(
                f"unknown downlink_codec {self.downlink_codec!r}; choose "
                f"from {CODEC_NAMES}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac={self.topk_frac!r} must be in "
                             "(0, 1]")
        if self.quant_bits not in (4, 8):
            raise ValueError(f"quant_bits={self.quant_bits!r} must be 4 "
                             "or 8")
        if self.participation not in PARTICIPATION_NAMES:
            raise ValueError(
                f"unknown participation {self.participation!r}; choose from "
                f"{PARTICIPATION_NAMES}")
        if self.controller not in CONTROLLER_NAMES:
            raise ValueError(f"unknown controller {self.controller!r}; "
                             f"choose from {CONTROLLER_NAMES}")

    @property
    def compressed(self) -> bool:
        return (self.uplink_codec, self.downlink_codec) != \
            ("identity", "identity")
