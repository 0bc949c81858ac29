"""gemma3-1b [dense] — 5:1 local:global attention, 128k context (port of
``repro/configs/gemma3_1b.py``).

[hf:google/gemma-3-1b-pt]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding window 512 on local layers, every 6th layer global.
"""
from repro_torch.configs.base import ArchConfig, local_global_pattern

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    block_pattern=local_global_pattern(26, local=5, global_=1),
    sliding_window=512,
    rope_theta=1e6,
    act="gelu",
    fl_mode="client_parallel",
    source="hf:google/gemma-3-1b-pt",
)
