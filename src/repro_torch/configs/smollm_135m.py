"""smollm-135m [dense] — llama-arch small (port of
``repro/configs/smollm_135m.py``).

[hf:HuggingFaceTB/SmolLM-135M]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    rope_theta=10_000.0,
    fl_mode="client_parallel",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
