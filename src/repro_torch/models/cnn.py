"""The paper's CNN models (§4.1.1), split into extractor / classifier
(port of ``repro/models/cnn.py``).

The public layout is the JAX package's: images and feature maps are NHWC,
and ``cnn_head`` flattens in (h, w, C) order, so FC weights carry across
unchanged.  Conv weights are stored OIHW (``interop`` converts HWIO) and
the convolutions run in NCHW, padded by 2 for the 5x5 "SAME" convs, with
"VALID" max-pooling.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig
from repro_torch.models.layers import dense_init

KERNEL = 5


def _conv_init(generator, k, cin, cout, dtype):
    return {
        "w": dense_init(generator, (cout, cin, k, k), dtype,
                        scale=1.0 / (k * (cin ** 0.5))),
        "b": torch.zeros((cout,), dtype=dtype, device=generator.device),
    }


def cnn_init(cfg: CNNConfig, generator: torch.Generator,
             dtype=torch.float32):
    """Params on the generator's device: ``{"convs": [{"w", "b"}...],
    "fcs": [...], "head": {...}}`` as in the JAX package (conv ``w``
    OIHW)."""
    convs = []
    cin = cfg.input_shape[-1]
    for cout in cfg.conv_channels:
        convs.append(_conv_init(generator, KERNEL, cin, cout, dtype))
        cin = cout
    h, w = cfg.feature_hw
    fcs = []
    d = h * w * cin
    for units in cfg.fc_units:
        fcs.append({"w": dense_init(generator, (d, units), dtype),
                    "b": torch.zeros((units,), dtype=dtype,
                                     device=generator.device)})
        d = units
    head = {"w": dense_init(generator, (d, cfg.n_classes), dtype),
            "b": torch.zeros((cfg.n_classes,), dtype=dtype,
                             device=generator.device)}
    return {"convs": convs, "fcs": fcs, "head": head}


def cnn_extract(cfg: CNNConfig, params, x):
    """x [B,H,W,C_in] -> feature maps [B,h,w,C] (contiguous NHWC)."""
    h = x.permute(0, 3, 1, 2)
    for conv in params["convs"]:
        h = F.conv2d(h, conv["w"], conv["b"], padding=KERNEL // 2)
        h = F.relu(h)
        h = F.max_pool2d(h, cfg.pool_size, cfg.pool_stride)
    return h.permute(0, 2, 3, 1).contiguous()


def cnn_head(cfg: CNNConfig, params, feats):
    """feats [B,h,w,C] -> logits [B,n_classes].  Dropout never fires on the
    federated path (the JAX bundle calls the head without an rng), so the
    port has none."""
    h = feats.reshape(feats.shape[0], -1)
    for fc in params["fcs"]:
        h = F.relu(h @ fc["w"] + fc["b"])
    return h @ params["head"]["w"] + params["head"]["b"]


def cnn_apply(cfg: CNNConfig, params, x):
    feats = cnn_extract(cfg, params, x)
    return {"features": feats, "logits": cnn_head(cfg, params, feats),
            "aux": 0.0}
