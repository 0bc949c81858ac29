"""stablelm-3b [dense] — partial rotary embeddings (port of
``repro/configs/stablelm_3b.py``).

[hf:stabilityai/stablelm-2-1_6b]
32L d_model=2560 32H (GQA kv=32, full MHA) d_ff=6912 vocab=50304,
25% partial rotary.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
    partial_rotary_pct=0.25,
    rope_theta=10_000.0,
    tie_embeddings=False,
    fl_mode="client_parallel",
    source="hf:stabilityai/stablelm-2-1_6b",
)
