"""mamba2-130m [ssm] — SSD (state-space duality), attention-free (port of
``repro/configs/mamba2_130m.py``).

[arXiv:2405.21060]
24L d_model=768, ssm_state=128, expand=2 (d_inner=1536), head_dim=64
(24 SSD heads), chunked SSD scan, vocab=50280.
"""
from repro_torch.configs.base import ArchConfig, SSD

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,            # SSD heads = expand*d_model / ssm_head_dim
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=(SSD,) * 24,
    ssm_state=128,
    ssm_expand=2,
    ssm_chunk=64,
    ssm_head_dim=64,
    ssm_conv_width=4,
    fl_mode="client_parallel",
    source="arXiv:2405.21060",
)
