"""whisper-large-v3 [audio] — encoder-decoder, conv frontend (stub) (port
of ``repro/configs/whisper_large_v3.py``).

[arXiv:2212.04356]
32L (decoder) d_model=1280 20H (kv=20, full MHA) d_ff=5120 vocab=51866,
plus a 32-layer encoder over 1500 stub frame embeddings.  The
mel-spectrogram and conv feature extractor are a stub: the batch carries
precomputed frame embeddings [B, 1500, 1280] (``audio_frames``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    n_enc_layers=32,
    n_audio_frames=1500,
    act="gelu",
    rope_theta=0.0,          # whisper uses sinusoidal positions
    tie_embeddings=True,
    fl_mode="client_parallel",
    source="arXiv:2212.04356",
)
