"""arctic-480b [moe] — 128 experts top-2 + dense residual (port of
``repro/configs/arctic_480b.py``).

[hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Dense-MoE hybrid: a dense FFN residual runs in parallel with the MoE FFN.
Too large for per-client replicas -> client_sequential FL mode with
FSDP+expert-parallel sharding (on a mesh with ``data`` > 1 its round is
``launch.steps``' FSDP round: the experts split over ``data`` are
gathered where a layer uses them).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    rope_theta=1e6,
    fl_mode="client_sequential",
    source="hf:Snowflake/snowflake-arctic-base",
)
