"""Synthetic image data (copy of ``repro/data/synth.py:class_images``).

K Gaussian-blob class templates plus pixel noise, shaped like MNIST
(28x28x1) or CIFAR (32x32x3).  The numpy rng stream is draw-for-draw the
JAX package's, so both packages see the same images for one seed.
"""
from __future__ import annotations

import numpy as np


def class_images(n_per_class, *, n_classes=10, shape=(28, 28, 1), seed=0,
                 noise=0.35, blobs_per_class=3, template_seed=None):
    """Returns x [N,H,W,C] float32 in [0,1]-ish, y [N] int32.

    ``template_seed`` fixes the class templates independently of the
    noise/shuffle seed, so a train split (seed=0) and a test split (seed=1)
    sample the SAME class-conditional distribution — pass the same
    template_seed to both.  Defaults to ``seed`` (templates follow seed).
    """
    t_rng = np.random.default_rng(
        seed if template_seed is None else template_seed)
    rng = np.random.default_rng(seed)
    H, W, C = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    templates = np.zeros((n_classes, H, W, C), np.float32)
    my, mx = min(4, H // 4), min(4, W // 4)  # margin, small-image safe
    for c in range(n_classes):
        for _ in range(blobs_per_class):
            cy, cx = t_rng.uniform(my, H - my), t_rng.uniform(mx, W - mx)
            sig = t_rng.uniform(1.5, 3.5)
            amp = t_rng.uniform(0.6, 1.0)
            blob = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                / (2 * sig ** 2))
            ch = t_rng.integers(0, C)
            templates[c, :, :, ch] += blob
    templates = np.clip(templates, 0, 1.5)

    xs, ys = [], []
    for c in range(n_classes):
        imgs = templates[c][None] + noise * rng.standard_normal(
            (n_per_class, H, W, C)).astype(np.float32)
        xs.append(imgs)
        ys.append(np.full(n_per_class, c, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), y[perm]
