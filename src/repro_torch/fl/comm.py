"""Communication-cost accounting (port of ``repro/fl/comm.py``).

The paper's metric is *communication rounds to reach an accuracy
milestone*; raw bytes are accounted too (down = global model broadcast,
up = local model + fusion module returns).  Byte counts follow the
parameter trees' shapes and dtypes and the codecs' wire sizes, so they
equal the JAX package's.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.runlog import json_safe
from repro_torch.tree import tree_leaves


def tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


@dataclass
class CommLog:
    rounds: int = 0
    bytes_up: int = 0
    bytes_down: int = 0
    history: List[Dict] = field(default_factory=list)
    _model_b: Optional[int] = field(default=None, repr=False)
    _fusion_b: Optional[int] = field(default=None, repr=False)

    def bind_sizes(self, global_state) -> "CommLog":
        """Precompute the model/fusion wire sizes once; afterwards
        ``log_round`` accepts ``global_state=None``."""
        self._model_b = tree_bytes(global_state["model"])
        self._fusion_b = tree_bytes(global_state.get("fusion", ()))
        return self

    def log_round(self, global_state, n_clients: int, metrics: Dict, *,
                  wire_up: Optional[int] = None,
                  wire_down: Optional[int] = None,
                  n_down: Optional[int] = None,
                  n_up: Optional[int] = None,
                  effective: Optional[Dict] = None):
        """Account one round.

        ``wire_up`` / ``wire_down``: codec-reported bytes per client for the
        model payload (``repro_torch.compress``); None charges the raw
        model size.  FedFusion's fusion module crosses the wire
        uncompressed both ways, to and from the ``n_clients``
        participants.  ``n_down``: receivers of the model broadcast
        (default ``n_clients``); a mirror-based downlink codec is a
        multicast stream every client must hear, so the server passes the
        federation size there.  ``n_up``: uploaders this round (default
        ``n_clients``); a partial-participation round (deadline /
        buffered-async policies, chaos dropouts) receives uploads only from
        the clients that arrived, while the downlink keeps charging the
        whole cohort, which started the round.  ``effective``: an adaptive
        controller's effective codec configuration of the round
        (``{"level": int, "eff_topk_frac": float}`` or ``{"level": int,
        "eff_quant_bits": int}``, ``repro_torch.control``), merged into the
        round record so the schedule can be read back from the history;
        ``wire_up`` is then the level's effective bytes.  None (static
        runs) keeps the record shape unchanged.
        """
        if global_state is None:
            if self._model_b is None:
                raise RuntimeError(
                    "CommLog.log_round(global_state=None) requires "
                    "bind_sizes(global_state) to have been called first")
            model_b, fusion_b = self._model_b, self._fusion_b
        else:
            model_b = tree_bytes(global_state["model"])
            fusion_b = tree_bytes(global_state.get("fusion", ()))
        n_down = n_clients if n_down is None else n_down
        down = (n_down * (model_b if wire_down is None else wire_down)
                + n_clients * fusion_b)
        n_up = n_clients if n_up is None else n_up
        up = n_up * ((model_b if wire_up is None else wire_up) + fusion_b)
        self.rounds += 1
        self.bytes_down += down
        self.bytes_up += up
        self.history.append({"round": self.rounds, "bytes_up": up,
                             "bytes_down": down,
                             "bytes_up_ideal": n_clients * (model_b
                                                            + fusion_b),
                             "cum_bytes_up": self.bytes_up,
                             **(effective or {}), **metrics})

    def rounds_to(self, key: str, threshold: float) -> int:
        """First round where history[key] >= threshold (-1 if never)."""
        for h in self.history:
            if h.get(key, -np.inf) >= threshold:
                return h["round"]
        return -1

    def to_records(self) -> List[Dict]:
        """History as plain-JSON round records plus a final
        ``{"kind": "summary", "schema": 2}`` record with the run totals
        (record schema v2 of the JAX package: round records may carry the
        controller's effective fields).  ``repro_torch.obs.report`` reads
        these records beside a run log's."""
        records = [{"kind": "round",
                    **{k: json_safe(v) for k, v in h.items()}}
                   for h in self.history]
        records.append({"kind": "summary", "schema": 2,
                        "rounds": self.rounds,
                        "bytes_up": self.bytes_up,
                        "bytes_down": self.bytes_down})
        return records

    def save(self, path: str) -> str:
        """Write :meth:`to_records` as JSONL; returns ``path``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for rec in self.to_records():
                f.write(json.dumps(rec) + "\n")
        return path
