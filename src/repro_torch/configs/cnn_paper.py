"""The paper's own CNN models (§4.1.1), as in ``repro/configs/cnn_paper.py``.

MNIST: two 5x5 convs (32, 64 ch) each + ReLU + 2x2 maxpool, FC 512 + ReLU +
dropout, softmax head.
CIFAR: two 5x5 convs (64, 64 ch) each + ReLU + 3x3 maxpool stride 2,
FC 384 -> FC 192 each + ReLU + dropout, softmax head.
"""
from repro_torch.configs.base import CNNConfig

CNN_MNIST = CNNConfig(
    name="cnn_mnist",
    input_shape=(28, 28, 1),
    conv_channels=(32, 64),
    pool_size=2,
    pool_stride=2,
    fc_units=(512,),
    n_classes=10,
)

CNN_CIFAR = CNNConfig(
    name="cnn_cifar",
    input_shape=(32, 32, 3),
    conv_channels=(64, 64),
    pool_size=3,
    pool_stride=2,
    fc_units=(384, 192),
    n_classes=10,
)
