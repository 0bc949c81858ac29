"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 (port of
``repro/configs/recurrentgemma_9b.py``).

[arXiv:2402.19427]
38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000.
Block pattern repeats (RG-LRU, RG-LRU, local-attention).
"""
from repro_torch.configs.base import ArchConfig, hybrid_pattern

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=hybrid_pattern(38, recurrent=2, attn=1),
    sliding_window=2048,
    lru_width=4096,
    rope_theta=10_000.0,
    act="gelu",
    fl_mode="client_sequential",
    source="arXiv:2402.19427",
)
