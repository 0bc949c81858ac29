"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (port of
``repro/configs/qwen2_vl_7b.py``).

[arXiv:2409.12191]
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The vision encoder (ViT + merger) is a stub: the batch carries precomputed
patch embeddings [B, n_vision_tokens, d_model] (``vision_embeds``); the
language backbone applies M-RoPE over (temporal, height, width) position
sections.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    mrope=True,
    mrope_sections=(16, 24, 24),   # t, h, w sections of the 64 rotary pairs
    rope_theta=1e6,
    n_vision_tokens=256,
    tie_embeddings=False,
    fl_mode="client_sequential",
    source="arXiv:2409.12191",
)
