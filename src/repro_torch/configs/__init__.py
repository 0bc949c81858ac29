"""Model and federated-learning configurations of the port.

``ARCH_CONFIGS`` holds every architecture of the JAX package: the four
dense attention configs (gemma3-1b, smollm-135m, stablelm-3b,
h2o-danube-3-4b), the two MoE configs (granite-moe-1b-a400m,
arctic-480b), the SSM config (mamba2-130m), the hybrid RG-LRU config
(recurrentgemma-9b), the VLM (qwen2-vl-7b) and the encoder-decoder
(whisper-large-v3).
"""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, CNNConfig,
                                      FLConfig, InputShape)
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.cnn_paper import CNN_CIFAR, CNN_MNIST
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.h2o_danube3_4b import CONFIG as H2O_DANUBE3_4B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.recurrentgemma_9b import \
    CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM_135M
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

CNN_CONFIGS = {c.name: c for c in (CNN_MNIST, CNN_CIFAR)}
ARCH_CONFIGS = {c.name: c for c in (GEMMA3_1B, SMOLLM_135M, STABLELM_3B,
                                    H2O_DANUBE3_4B, GRANITE_MOE_1B,
                                    ARCTIC_480B, MAMBA2_130M,
                                    RECURRENTGEMMA_9B, QWEN2_VL_7B,
                                    WHISPER_LARGE_V3)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCH_CONFIGS)}")
    return ARCH_CONFIGS[name]


__all__ = ["ArchConfig", "CNNConfig", "FLConfig", "InputShape",
           "INPUT_SHAPES", "CNN_CONFIGS",
           "CNN_MNIST", "CNN_CIFAR", "ARCH_CONFIGS", "GEMMA3_1B",
           "SMOLLM_135M", "STABLELM_3B", "H2O_DANUBE3_4B", "GRANITE_MOE_1B",
           "ARCTIC_480B", "MAMBA2_130M", "RECURRENTGEMMA_9B", "QWEN2_VL_7B",
           "WHISPER_LARGE_V3", "get_config"]
