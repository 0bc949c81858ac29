"""FedProx (Li et al., arXiv:1812.06127) as an OUT-OF-CORE plugin (port of
``repro/contrib/fedprox.py``).

A proximal-term variant of the paper's client-side objective,

    L = L_cls(theta_L) + (mu / 2) * ||Theta_L - Theta_G||^2,

built purely from the public :class:`repro_torch.fl.api.Algorithm` hook
API, with no edits to ``repro_torch.core``, ``repro_torch.engine`` or the
round functions: it composes with every wire codec, both execution modes,
the engine's supersteps and the participation policies, because those
layers only talk to the hook interface.
"""
from __future__ import annotations

from repro_torch.core.losses import l2_tree_distance
from repro_torch.fl.api.algorithm import Algorithm, register_algorithm
from repro_torch.fl.api.plugins import classify_loss

__all__ = ["FedProx"]


class FedProx(Algorithm):
    """Proximal local objective; strength via ``FLConfig.prox_mu``."""

    name = "fedprox"

    def local_loss(self, bundle, fl, trainable, global_model, batch,
                   cached_feats_g=None):
        cls, _, _ = classify_loss(bundle, trainable["model"], batch)
        prox = 0.5 * fl.prox_mu * l2_tree_distance(trainable["model"],
                                                   global_model)
        return cls + prox, {"cls": cls, "prox": prox}


register_algorithm(FedProx())
