"""MK-MMD loss for two-stream federated learning (port of
``repro/core/mmd.py``; paper §2.2, §3.1)."""
from __future__ import annotations

from repro_torch.kernels import ops


def mmd_loss(local_feats, global_feats, widths, lam):
    """lam * MMD^2(theta_G(X), theta_L(X))  — paper Eq. (5).

    ``local_feats`` / ``global_feats``: pooled per-example features [B, C]
    (the outputs of the two streams on the same local batch X^t).
    """
    return lam * ops.mk_mmd2(local_feats, global_feats, widths)
