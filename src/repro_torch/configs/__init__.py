"""Model and federated-learning configurations of the port."""
from repro_torch.configs.base import CNNConfig, FLConfig
from repro_torch.configs.cnn_paper import CNN_CIFAR, CNN_MNIST

CNN_CONFIGS = {c.name: c for c in (CNN_MNIST, CNN_CIFAR)}

__all__ = ["CNNConfig", "FLConfig", "CNN_CONFIGS", "CNN_MNIST", "CNN_CIFAR"]
