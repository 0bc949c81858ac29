"""granite-moe-1b-a400m [moe] — 32 experts top-8 (port of
``repro/configs/granite_moe_1b.py``).

[hf:ibm-granite/granite-3.0-1b-a400m-base]
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    rope_theta=10_000.0,
    fl_mode="client_parallel",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
