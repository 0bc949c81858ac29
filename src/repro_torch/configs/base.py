"""Configuration dataclasses (port of ``repro/configs/base.py``).

``ArchConfig`` keeps every field, default and check of the JAX package's,
with ``param_count`` and ``reduced()``, so any JAX architecture config is
representable; the model code refuses the families it does not run yet.

``FLConfig`` keeps the fields the federated training path reads, with the
same names, defaults and validation as the JAX package, the adaptive
compression controller's (``controller``, ``ladder``, ``ctrl_*``)
included; the reference loop refuses a controller, as JAX's does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

# Block kinds appearing in ``ArchConfig.block_pattern``.
ATTN_GLOBAL = "attn_global"     # full causal attention
ATTN_LOCAL = "attn_local"       # sliding-window causal attention
RGLRU = "rglru"                 # RecurrentGemma RG-LRU recurrent block
SSD = "ssd"                     # Mamba-2 state-space-duality block

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
FL_MODES = ("client_parallel", "client_sequential")

# Wire codecs, participation policies and compression controllers of the
# JAX package (literal copies of repro.configs.base's tuples).
CODEC_NAMES = ("identity", "quant", "int8", "int4", "topk", "topk_noef",
               "mask", "lowrank")
PARTICIPATION_NAMES = ("full_sync", "deadline", "buffered_async")
CONTROLLER_NAMES = ("static", "ef_ratio", "bytes_budget", "loss_trend")
_LADDER_CODECS = ("topk", "topk_noef", "quant", "int8", "int4")

# Algorithm plugins registered by repro_torch.fl.api.plugins (and the
# contrib FedProx); names registered at runtime are validated against the
# live registry lazily.
ALGORITHM_NAMES = ("fedavg", "fedmmd", "fedfusion", "fedl2", "fedprox")


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
    prox_mu: float = 0.01             # FedProx proximal strength (contrib)
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
    # --- participation policy (repro_torch.fl.participation) ---
    participation: str = "full_sync"  # a PARTICIPATION_NAMES / registry name
    over_provision: float = 1.5       # deadline: cohort C' = ceil(C * this)
    buffer_k: int = 0                 # buffered_async: close at K-th arrival
    # (0 -> clients_per_round // 2)
    staleness_alpha: float = 0.5      # buffered_async: (1+s)^(-alpha) weight
    # --- adaptive compression controller (repro_torch.control) ---
    controller: str = "static"        # a CONTROLLER_NAMES / registry name
    ladder: Tuple[float, ...] = ()    # ascending effective levels, top =
    # the codec's static parameter; () -> a default 3-level topk ladder
    # (f/4, f/2, f) or the quant ladder (4, 8)
    ctrl_band: Tuple[float, float] = (0.5, 2.0)  # ef_ratio hold band
    ctrl_budget_frac: float = 0.5     # bytes_budget: frac of capacity/round
    ctrl_ema: float = 0.8             # controller signal EMA coefficient

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
            from repro_torch.fl.participation import registered_policies
            if self.participation not in registered_policies():
                raise ValueError(
                    f"unknown participation {self.participation!r}; "
                    f"registered: {registered_policies()}")
        if self.over_provision < 1.0:
            raise ValueError(f"over_provision={self.over_provision!r} must "
                             "be >= 1.0")
        if self.buffer_k < 0:
            raise ValueError(f"buffer_k={self.buffer_k!r} must be >= 0")
        if self.staleness_alpha < 0.0:
            raise ValueError(f"staleness_alpha={self.staleness_alpha!r} "
                             "must be >= 0.0")
        if self.controller not in CONTROLLER_NAMES:
            from repro_torch.control import registered_controllers
            if self.controller not in registered_controllers():
                raise ValueError(
                    f"unknown controller {self.controller!r}; registered: "
                    f"{registered_controllers()}")
        if self.ladder and (list(self.ladder) != sorted(set(self.ladder))):
            raise ValueError(f"ladder {self.ladder!r} must be strictly "
                             "ascending")
        if self.controller != "static" and \
                self.uplink_codec not in _LADDER_CODECS:
            raise ValueError(
                f"controller {self.controller!r} needs a ladder-capable "
                f"uplink codec {_LADDER_CODECS}, got "
                f"{self.uplink_codec!r}")
        if len(self.ctrl_band) != 2 or not \
                0.0 <= self.ctrl_band[0] < self.ctrl_band[1]:
            raise ValueError(f"ctrl_band {self.ctrl_band!r} must be "
                             "(lo, hi) with 0 <= lo < hi")
        if not 0.0 < self.ctrl_budget_frac <= 1.0:
            raise ValueError(
                f"ctrl_budget_frac={self.ctrl_budget_frac!r} must be in "
                "(0, 1]")
        if not 0.0 <= self.ctrl_ema < 1.0:
            raise ValueError(f"ctrl_ema={self.ctrl_ema!r} must be in "
                             "[0, 1)")

    @property
    def compressed(self) -> bool:
        return (self.uplink_codec, self.downlink_codec) != \
            ("identity", "identity")


@dataclass(frozen=True)
class InputShape:
    """One of the assigned (seq_len, global_batch) evaluation shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"{self.name}: kind {self.kind!r} must be "
                             "'train', 'prefill' or 'decode'")


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture from the assigned pool."""

    name: str
    family: str                     # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ()   # () -> all ATTN_GLOBAL

    # --- attention details ---
    sliding_window: int = 4096      # window for ATTN_LOCAL blocks
    rope_theta: float = 10_000.0
    partial_rotary_pct: float = 1.0
    mrope: bool = False             # Qwen2-VL multimodal RoPE (3 sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # 0 -> d_ff
    dense_residual: bool = False    # Arctic: dense FFN in parallel with MoE
    moe_capacity: float = 1.25      # expert capacity factor (train/prefill)

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0              # 0 -> d_model

    # --- encoder / modality frontend stubs ---
    n_enc_layers: int = 0           # whisper encoder depth (0 = decoder-only)
    n_audio_frames: int = 1500      # stub encoder sequence length
    n_vision_tokens: int = 0        # VLM: number of stub patch embeddings

    # --- misc ---
    norm_eps: float = 1e-6
    act: str = "silu"               # "silu" (SwiGLU) or "gelu" (plain MLP)
    tie_embeddings: bool = True
    max_seq_len: int = 524_288

    # --- distribution plan ---
    fl_mode: str = "client_parallel"
    source: str = ""                # citation bracket from the assignment

    # --- performance knobs ---
    remat: str = "none"             # none | attn | layer  (activation ckpt)
    attn_impl: str = "jnp"          # jnp (plain torch) | pallas (K8a / K9)
    serve_expert_parallel: bool = False  # shard experts over data at serve
    moe_shard_capacity: bool = False     # capacity dim over 'model' (no vmap)
    moe_dispatch: str = "gather"         # gather | a2a

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: family {self.family!r} not in "
                             f"{FAMILIES}")
        if self.fl_mode not in FL_MODES:
            raise ValueError(f"{self.name}: fl_mode {self.fl_mode!r} not in "
                             f"{FL_MODES}")
        if self.remat not in ("none", "attn", "layer"):
            raise ValueError(f"{self.name}: remat {self.remat!r} must be "
                             "'none', 'attn' or 'layer'")
        if self.attn_impl not in ("jnp", "pallas"):
            raise ValueError(f"{self.name}: attn_impl {self.attn_impl!r} "
                             "must be 'jnp' or 'pallas'")
        if self.moe_dispatch not in ("gather", "a2a"):
            raise ValueError(f"{self.name}: moe_dispatch "
                             f"{self.moe_dispatch!r} must be 'gather' or "
                             "'a2a'")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern",
                               (ATTN_GLOBAL,) * self.n_layers)
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern len {len(self.block_pattern)} != "
                f"{self.n_layers}")
        if self.n_experts and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"{self.name}: top_k {self.top_k} must be in "
                             f"(0, n_experts={self.n_experts}]")
        if self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def has_subquadratic_decode(self) -> bool:
        """True if the decode-time cache is sub-linear in context length for
        most layers (SSM state, RG-LRU state or sliding-window caches)."""
        return any(b in (SSD, RGLRU, ATTN_LOCAL) for b in self.block_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (the JAX package's formula)."""
        d, h, kv, hd = (self.d_model, self.n_heads, self.n_kv_heads,
                        self.head_dim)
        per_attn = d * h * hd + 2 * d * kv * hd + h * hd * d    # q,k,v,o
        mlp_mult = 3 if self.act == "silu" else 2
        per_dense_ff = mlp_mult * d * self.d_ff
        n = 0
        for blk in self.block_pattern:
            if blk in (ATTN_GLOBAL, ATTN_LOCAL):
                n += per_attn
            elif blk == RGLRU:
                w = self.lru_width
                n += 3 * d * w + 2 * w * w + 5 * w
            elif blk == SSD:
                d_in = self.ssm_expand * d
                n += 2 * d * d_in + d_in * self.ssm_state * 2 + d_in * d
            if self.n_experts:
                n += (self.n_experts * mlp_mult * d * self.moe_d_ff
                      + d * self.n_experts)
                if self.dense_residual:
                    n += per_dense_ff
            elif blk not in (SSD,):
                n += per_dense_ff
            n += 2 * d  # norms
        n += self.vocab_size * d  # embedding (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.n_enc_layers:
            n += self.n_enc_layers * (per_attn + per_dense_ff + 2 * d)
            n += self.n_layers * per_attn  # decoder cross-attention
        return n

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts, tiny
        vocab; keeps the family shape (block kinds, GQA flavour)."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.n_heads, 4))
        if self.n_kv_heads == self.n_heads:
            kv = heads
        elif self.n_kv_heads == 1:
            kv = 1
        else:
            kv = 2
        kinds = [k for k in (SSD, RGLRU, ATTN_LOCAL, ATTN_GLOBAL)
                 if k in self.block_pattern]
        pattern = tuple((kinds * 2)[:2]) if kinds else (ATTN_GLOBAL,
                                                        ATTN_GLOBAL)
        n_exp = min(self.n_experts, 4)
        half = (d // heads) // 2
        t_sec = half * 2 // 8
        h_sec = half * 3 // 8
        sections = (t_sec, h_sec, half - t_sec - h_sec)
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) or 512,
            moe_d_ff=min(self.moe_d_ff, 256) if self.n_experts else 0,
            vocab_size=min(self.vocab_size, 512),
            mrope_sections=sections,
            block_pattern=pattern,
            sliding_window=64,
            n_experts=n_exp,
            top_k=min(self.top_k, n_exp) if n_exp else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_chunk=8,
            ssm_head_dim=16,
            lru_width=d,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_audio_frames=16,
            n_vision_tokens=min(self.n_vision_tokens, 8),
            max_seq_len=512,
        )


def local_global_pattern(n_layers: int, local: int, global_: int,
                         window_kind: str = ATTN_LOCAL) -> Tuple[str, ...]:
    """`local:global` repeating pattern, e.g. gemma3's 5:1."""
    pat = []
    cycle = [window_kind] * local + [ATTN_GLOBAL] * global_
    while len(pat) < n_layers:
        pat.extend(cycle)
    return tuple(pat[:n_layers])


def hybrid_pattern(n_layers: int, recurrent: int = 2,
                   attn: int = 1) -> Tuple[str, ...]:
    """RecurrentGemma's (RG-LRU, RG-LRU, local-attn) repeating pattern."""
    pat = []
    cycle = [RGLRU] * recurrent + [ATTN_LOCAL] * attn
    while len(pat) < n_layers:
        pat.extend(cycle)
    return tuple(pat[:n_layers])
