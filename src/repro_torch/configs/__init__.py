"""Model and federated-learning configurations of the port.

``ARCH_CONFIGS`` holds the transformer architectures the port serves and
trains so far (the dense attention family); :func:`get_config` of any
other JAX architecture raises a ``KeyError`` that names the slice that
brings it.
"""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, CNNConfig,
                                      FLConfig, InputShape)
from repro_torch.configs.cnn_paper import CNN_CIFAR, CNN_MNIST
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM_135M

CNN_CONFIGS = {c.name: c for c in (CNN_MNIST, CNN_CIFAR)}
ARCH_CONFIGS = {c.name: c for c in (GEMMA3_1B, SMOLLM_135M)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_CONFIGS:
        raise KeyError(
            f"arch {name!r} is not ported yet (ported: "
            f"{sorted(ARCH_CONFIGS)}); the other families (MoE, SSM, "
            "hybrid, VLM, audio) are a later slice (ROADMAP Queue 1, "
            "slice 6: the other model families)")
    return ARCH_CONFIGS[name]


__all__ = ["ArchConfig", "CNNConfig", "FLConfig", "InputShape",
           "INPUT_SHAPES", "CNN_CONFIGS",
           "CNN_MNIST", "CNN_CIFAR", "ARCH_CONFIGS", "GEMMA3_1B",
           "SMOLLM_135M", "get_config"]
