"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA (port of
``repro/configs/h2o_danube3_4b.py``).

[arXiv:2401.16818]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding-window attn.
"""
from repro_torch.configs.base import ArchConfig, ATTN_LOCAL

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10_240,
    vocab_size=32_000,
    block_pattern=(ATTN_LOCAL,) * 24,
    sliding_window=4096,
    rope_theta=10_000.0,
    fl_mode="client_parallel",
    source="arXiv:2401.16818",
)
