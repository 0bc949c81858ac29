"""Synthetic data (copy of ``repro/data/synth.py``: ``class_images`` and
``token_stream``).

Images: K Gaussian-blob class templates plus pixel noise, shaped like
MNIST (28x28x1) or CIFAR (32x32x3).  Tokens: per-source skewed unigram
streams with a learnable bigram twist.  The numpy rng streams are
draw-for-draw the JAX package's, so both packages see the same data for
one seed.
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


def token_stream(n_seqs, seq_len, *, vocab, n_sources=10, seed=0, alpha=0.3):
    """Returns tokens [N, seq_len+1] int32, source [N] int32.

    Each source s has a Dirichlet-skewed unigram distribution over a
    source-specific vocab slice, plus a shared bigram "grammar" so there's
    real next-token signal to learn.
    """
    rng = np.random.default_rng(seed)
    vocab_eff = min(vocab, 4096)  # keep the generator cheap; ids < vocab
    probs = rng.dirichlet(np.full(vocab_eff, alpha), size=n_sources)
    shift = rng.integers(1, vocab_eff, size=n_sources)

    toks = np.zeros((n_seqs, seq_len + 1), np.int64)
    src = rng.integers(0, n_sources, size=n_seqs)
    for i in range(n_seqs):
        s = src[i]
        draws = rng.choice(vocab_eff, size=seq_len + 1, p=probs[s])
        # deterministic bigram twist: every even position continues the
        # previous token's "phrase" (strong learnable structure)
        for t in range(1, seq_len + 1, 2):
            draws[t] = (draws[t - 1] + shift[s]) % vocab_eff
        toks[i] = draws
    return toks.astype(np.int32), src.astype(np.int32)
