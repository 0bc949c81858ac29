"""Top-k magnitude sparsification with client-side error feedback (port of
``repro/compress/topk.py``, without the ``level=`` ladder).

Per leaf (flattened, k = max(1, round(frac * n))): transmit the k largest-
magnitude entries as (int32 index, float32 value) pairs, 8k wire bytes
against 4n raw.  With error feedback the residual is the exact scatter
complement (``g`` with the sent entries set to 0), so a tie at the k-th
magnitude never leaks untransmitted mass; the dense threshold select K5
(``ops.topk_threshold_select``) is deliberately not used here, because a
tie at the threshold would make the dense mask disagree with the payload.
``torch.topk`` may order ties differently from ``lax.top_k``.
"""
from __future__ import annotations

import torch

from repro_torch.compress.codec import Codec


class TopKCodec(Codec):
    """Keep the top ``frac`` fraction of entries per leaf (by |value|)."""

    uses_noise = False

    def __init__(self, frac: float = 0.05, *, error_feedback: bool = True):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac={frac!r} must be in (0, 1]")
        self.frac = frac
        self.error_feedback = error_feedback
        self.stateful = error_feedback
        self.name = "topk" if error_feedback else "topk_noef"

    def _k(self, i) -> int:
        return max(1, int(round(self.frac * self._n(i))))

    def _init_leaf_state(self, i):
        if not self.error_feedback:
            return None
        return torch.zeros(self._n(i), device=self._device)

    def _encode_leaf(self, x, state, noise, i):
        g = x + state if self.error_feedback else x
        idx = torch.topk(g.abs(), self._k(i), sorted=False).indices
        payload = {"idx": idx.to(torch.int32), "val": g[idx]}
        if self.error_feedback:
            state = g.index_fill(0, idx, 0.0)
        return payload, state

    def _decode_leaf(self, payload, i):
        dense = torch.zeros(self._n(i), device=payload["val"].device)
        return dense.index_copy(0, payload["idx"].long(), payload["val"])

    def _leaf_wire_bytes(self, i) -> int:
        return 8 * self._k(i)     # int32 index + float32 value per entry
