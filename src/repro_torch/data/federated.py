"""Federated data loader for images and tokens (copy of
``repro/data/federated.py`` without ``TemplateClients``): samples clients
per round and builds the stacked round batch the round fn consumes
([n_clients, local_steps, B, ...]), or K rounds of them at once for the
engine (``round_chunk``).  Token clients hold ``{"tokens": [n, S+1]}``;
their batches carry ``tokens`` and ``labels`` [.., S], the next tokens.

It also hosts the deterministic *chaos layer* (:class:`ChaosConfig`):
per-client compute-speed draws, per-round dropout and arrival jitter, and
partial-local-epoch truncation, all keyed off the dataset's rng streams so
every fault schedule is reproducible, and replayable through
``skip_round_sampling`` on resume.

The numpy rng streams are draw-for-draw the JAX package's, so for one seed
both packages sample the same cohorts, batches and faults.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

# Above this federation size ``sample_clients`` switches from numpy's
# permutation-based ``choice`` to Floyd's O(C) without-replacement draw
# (the same threshold as the JAX package, so the streams agree).
_FLOYD_THRESHOLD = 4096


@dataclass(frozen=True)
class ChaosConfig:
    """Deterministic client-heterogeneity injection.

    ``speed_sigma``: sigma of the *static* per-client lognormal compute
    speed (drawn once at dataset construction from a seed-derived rng; a
    client's simulated arrival time is ``jitter / speed``).  ``jitter``:
    sigma of the per-(round, client) lognormal arrival jitter.
    ``dropout``: per-(round, client) probability of dropping out of the
    round.  ``truncation``: probability a surviving client completes only
    a uniform fraction of its local steps (simulated as a proportional
    cut to its example weight).  ``seed``: the static-speed stream seed;
    ``None`` derives it from the dataset seed.

    All per-round draws ride ``FederatedDataset._rng`` *after* the round's
    batch draws, in a fixed order, so a dataset seed reproduces the same
    fault schedule, also across interrupt + resume.
    """

    speed_sigma: float = 1.0
    jitter: float = 0.1
    dropout: float = 0.0
    truncation: float = 0.0
    seed: Optional[int] = None


@dataclass(frozen=True)
class ChaosDraws:
    """One round's chaos draws for the sampled cohort: ``arrival`` float32
    [cohort] simulated completion times (1.0 is a nominal median client),
    ``dropped`` bool [cohort], ``work`` float32 [cohort] in (0, 1], the
    fraction of local work a surviving client completed."""

    arrival: np.ndarray
    dropped: np.ndarray
    work: np.ndarray


class FederatedDataset:
    """Holds per-client datasets + a held-out test set."""

    def __init__(self, clients: List[Dict[str, np.ndarray]],
                 test: Dict[str, np.ndarray], *, seed: int = 0,
                 chaos: Optional[ChaosConfig] = None):
        self.clients = clients
        self.test = test
        self._sizes = None          # client_sizes cache (shards are frozen)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self.chaos = chaos
        if chaos is not None:
            # static heavy-tailed per-client speeds, from their own
            # seed-derived stream so they never perturb round sampling
            speed_rng = np.random.default_rng(
                seed if chaos.seed is None else chaos.seed)
            self._client_speed = speed_rng.lognormal(
                0.0, chaos.speed_sigma, len(clients)).astype(np.float32)

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    def client_sizes(self) -> np.ndarray:
        """Per-client example counts [N], computed once and cached."""
        if self._sizes is None:
            key = _key(self.clients[0])
            self._sizes = np.array([len(c[key]) for c in self.clients],
                                   np.float32)
        return self._sizes

    def sample_clients(self, n: int) -> np.ndarray:
        """Sample n distinct client ids; raises ``ValueError`` when
        ``n > n_clients``.  Federations above ``_FLOYD_THRESHOLD`` use
        Floyd's algorithm (O(n) rng calls), smaller ones numpy's
        permutation ``choice``."""
        if n > self.n_clients:
            raise ValueError(
                f"cannot sample {n} distinct clients from a federation of "
                f"{self.n_clients}; lower clients_per_round (or "
                f"over_provision for the deadline policy)")
        n_total = self.n_clients
        if n_total > _FLOYD_THRESHOLD:
            seen = set()
            picks = []
            for j in range(n_total - n, n_total):
                t = int(self._rng.integers(0, j + 1))
                pick = t if t not in seen else j
                seen.add(pick)
                picks.append(pick)
            cids = np.array(picks, np.int64)
        else:
            cids = self._rng.choice(n_total, size=n, replace=False)
        if len(np.unique(cids)) != len(cids):
            raise ValueError(
                f"sample_clients returned duplicate cids: {cids}")
        return cids

    def _draw(self, client: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
        size = len(client[_key(client)])
        idx = self._rng.choice(size, size=n, replace=size < n)
        return {k: v[idx] for k, v in client.items() if k != "perm"}

    def round_batch(self, client_ids, local_steps: int, batch: int):
        """Returns (batches, n_examples):
        batches: dict of arrays [n_clients, local_steps, batch, ...]
        n_examples: [n_clients] (n_t for weighting).
        """
        per_client = []
        for cid in client_ids:
            steps = [self._draw(self.clients[cid], batch)
                     for _ in range(local_steps)]
            per_client.append({k: np.stack([s[k] for s in steps])
                               for k in steps[0]})
        stacked = {k: np.stack([pc[k] for pc in per_client])
                   for k in per_client[0]}
        sizes = self.client_sizes()[np.asarray(client_ids)]
        return _to_batch(stacked), sizes

    def chaos_round(self, client_ids) -> Optional[ChaosDraws]:
        """Draw one round's fault schedule for ``client_ids``: exactly three
        draws from ``self._rng`` (jitter, dropout, truncation, in that
        order, each sized to the cohort) iff chaos is configured; None,
        consuming nothing, otherwise.  Callers invoke this right after
        ``round_batch``, so the stream position is a pure function of
        (seed, round index) and ``skip_round_sampling`` can replay it."""
        if self.chaos is None:
            return None
        c = self.chaos
        n = len(client_ids)
        jitter = self._rng.lognormal(0.0, c.jitter, n).astype(np.float32)
        dropped = self._rng.random(n) < c.dropout
        trunc = self._rng.random(2 * n).reshape(2, n)
        work = np.where(trunc[0] < c.truncation,
                        np.maximum(trunc[1], 1.0 / 16.0), 1.0)
        arrival = jitter / self._client_speed[np.asarray(client_ids)]
        return ChaosDraws(arrival=arrival, dropped=dropped,
                          work=work.astype(np.float32))

    def _consume_chaos_round(self, n: int) -> None:
        """Consume ``chaos_round``'s rng draws without materializing them
        (the ``skip_round_sampling`` replay counterpart)."""
        c = self.chaos
        self._rng.lognormal(0.0, c.jitter, n)
        self._rng.random(n)
        self._rng.random(2 * n)

    def round_chunk(self, n_rounds: int, clients_per_round: int,
                    local_steps: int, batch: int, *, pool=None,
                    participation: Optional[Callable] = None):
        """Sample ``n_rounds`` consecutive rounds for the engine: (cids
        [K, C] int32, batches {k: [K, C, steps, B, ...]}, sizes [K, C]
        float32).  Each round draws as ``sample_clients`` then
        ``round_batch`` then ``chaos_round`` do, in the same order, so the
        stream matches the one-round-at-a-time loop draw for draw.

        ``pool`` (a ``repro_torch.engine.pipeline.StagingPool``): the
        stacked arrays are written into its reusable (pinned) buffers
        instead of fresh memory; the caller must not refill the pool while
        a copy out of it is still in flight.

        ``participation`` (optional): a host callable ``draws ->
        RoundParticipation`` (``repro_torch.fl.participation``) called
        once per round with that round's :class:`ChaosDraws` (None when
        chaos is off).  When given, a fourth element is returned:
        ``{"mask", "staleness", "weight", "work"}`` [K, C] float32,
        ``"round_time"`` [K] float32 and ``"n_arrived"`` [K] int32.  Chaos
        draws are consumed iff ``self.chaos`` is set, whoever reads them.
        """
        cids_l, batch_l, size_l, part_l = [], [], [], []
        for _ in range(n_rounds):
            cids = self.sample_clients(clients_per_round)
            b, s = self.round_batch(cids, local_steps, batch)
            draws = self.chaos_round(cids)
            cids_l.append(cids)
            batch_l.append(b)
            size_l.append(s)
            if participation is not None:
                part_l.append((participation(draws), draws))

        def _stack(name, parts, dtype=None):
            dtype = dtype or parts[0].dtype
            shape = (len(parts),) + parts[0].shape
            out = pool.take(name, shape, dtype) if pool is not None else \
                np.empty(shape, dtype)
            for i, p in enumerate(parts):
                out[i] = p
            return out

        stacked = {k: _stack(f"batch/{k}", [b[k] for b in batch_l])
                   for k in batch_l[0]}
        out = (_stack("cids", cids_l, np.int32), stacked,
               _stack("sizes", size_l, np.float32))
        if participation is None:
            return out
        f32 = np.float32
        part = {
            "mask": _stack("part/mask", [p.mask for p, _ in part_l], f32),
            "staleness": _stack("part/staleness",
                                [p.staleness for p, _ in part_l], f32),
            "weight": _stack("part/weight",
                             [p.weight for p, _ in part_l], f32),
            # truncated clients complete a fraction of their local work,
            # simulated as a proportional example-weight cut (host-side)
            "work": _stack("part/work",
                           [np.ones_like(p.mask) if d is None else d.work
                            for p, d in part_l], f32),
            "round_time": np.array([p.round_time for p, _ in part_l], f32),
            "n_arrived": np.array([p.n_arrived for p, _ in part_l],
                                  np.int32),
        }
        return out + (part,)

    def skip_round_sampling(self, n_rounds: int, clients_per_round: int,
                            local_steps: int, batch: int) -> None:
        """Re-seed the sampling rng and consume exactly the draws the first
        ``n_rounds`` rounds make (``sample_clients`` + ``round_batch``, and
        the chaos draws when chaos is on, same order) without
        materializing batches."""
        self._rng = np.random.default_rng(self._seed)
        key = _key(self.clients[0])
        for _ in range(n_rounds):
            cids = self.sample_clients(clients_per_round)
            for cid in cids:
                size = len(self.clients[cid][key])
                for _ in range(local_steps):
                    self._rng.choice(size, size=batch, replace=size < batch)
            if self.chaos is not None:
                self._consume_chaos_round(len(cids))

    def test_batch(self, n: Optional[int] = None) -> Dict[str, np.ndarray]:
        if n is None:
            return _to_batch(dict(self.test))
        idx = self._rng.choice(len(self.test[_key(self.test)]), size=n,
                               replace=False)
        return _to_batch({k: v[idx] for k, v in self.test.items()})


def _key(d: Dict[str, np.ndarray]) -> str:
    """The array that counts examples: images or token sequences."""
    return "x" if "x" in d else "tokens"


def _to_batch(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Map raw arrays to model-batch keys (tokens -> tokens+labels)."""
    if "tokens" in d:
        toks = d.pop("tokens")
        d["tokens"] = toks[..., :-1]
        d["labels"] = toks[..., 1:]
    return d
