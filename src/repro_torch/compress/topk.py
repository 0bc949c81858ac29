"""Top-k magnitude sparsification with client-side error feedback (port of
``repro/compress/topk.py``).

Per leaf (flattened, k = max(1, round(frac * n))): transmit the k largest-
magnitude entries as (int32 index, float32 value) pairs, 8k wire bytes
against 4n raw.  With error feedback the residual is the exact scatter
complement (``g`` with the sent entries set to 0), so a tie at the k-th
magnitude never leaks untransmitted mass; the dense threshold select K5
(``ops.topk_threshold_select``) is deliberately not used here, because a
tie at the threshold would make the dense mask disagree with the payload.
``torch.topk`` may order ties differently from ``lax.top_k``.

Level ladder (``set_ladder``, fracs ascending, top = the codec's frac):
the encode at a level takes the capacity top-k sorted by magnitude, so its
first ``k_level`` slots are the level's exact top-k; the other slots send
0 and keep their value in the EF residual.  ``k_table[level]`` is read on
the device (a per-leaf int32 table made once), so the payload keeps its
capacity shape at every level.
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

    # -- level ladder ---------------------------------------------------
    def set_ladder(self, values):
        vals = tuple(float(v) for v in values)
        if not vals or list(vals) != sorted(set(vals)):
            raise ValueError(f"ladder {values!r} must be strictly ascending")
        if not all(0.0 < v <= 1.0 for v in vals):
            raise ValueError(f"ladder {values!r} needs fracs in (0, 1]")
        if vals[-1] != self.frac:
            raise ValueError(f"ladder top {vals[-1]} must equal the codec's "
                             f"capacity frac {self.frac}")
        self._ladder = vals
        self._tables = {}
        return self

    def _level_tables(self, i, device):
        """Leaf ``i``'s (k per level int32 [L], slot ranks [k_cap]) on
        ``device``, made on first use (outside any capture: the engine's
        warm-up runs first) and kept."""
        key = (i, str(device))
        tables = self._tables.get(key)
        if tables is None:
            ks = [max(1, int(round(f * self._n(i)))) for f in self._ladder]
            tables = self._tables[key] = (
                torch.tensor(ks, dtype=torch.int32, device=device),
                torch.arange(self._k(i), dtype=torch.int32, device=device))
        return tables

    def _encode_leaf_level(self, x, state, noise, i, level):
        g = x + state if self.error_feedback else x
        idx = torch.topk(g.abs(), self._k(i), sorted=True).indices
        k_table, ranks = self._level_tables(i, g.device)
        # sorted by magnitude: the first k_level slots ARE the level's exact
        # top-k; the rest of the capacity-shaped payload sends 0
        keep = ranks < k_table.index_select(0, level.reshape(1))
        sent = g[idx]
        payload = {"idx": idx.to(torch.int32),
                   "val": torch.where(keep, sent, 0.0)}
        if self.error_feedback:
            # masked-out slots write their own value back: the residual
            # keeps exactly what the effective level did not transmit
            state = g.index_copy(0, idx, torch.where(keep, 0.0, sent))
        return payload, state

    def level_bytes(self):
        if self._ladder is None:
            raise ValueError("set_ladder first")
        return tuple(sum(8 * max(1, int(round(f * self._n(i))))
                         for i in range(len(self._shapes)))
                     for f in self._ladder)
