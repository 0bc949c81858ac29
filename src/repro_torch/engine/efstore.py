"""Cohort-paged error-feedback store (port of ``repro/engine/efstore.py``
for one device): O(C·n) device memory at any federation size N.

The compressed engine keeps one EF residual row per client.  The dense
backing is a ``[N, n]`` table per leaf on the card; this module replaces
the backing store without touching the chunk's round math, which only
ever addresses rows through ``cids``:

* :class:`HostEFStore` — host rows keyed by client id; an absent key is
  the all-zero row, so a fresh store equals a fresh dense table.
* :func:`plan_chunk_static` — a chunk's ``cids [K, C]`` -> a
  :class:`PagePlan`: every distinct client gets one page slot (a
  *virtual cid*), so the superstep's gather and scatter run unchanged on
  a ``[K*C, n]`` page.
* :class:`EFPager` — ``stage`` (prefetch thread) gathers the next chunk's
  rows from the store into a zeroed host page; ``patch`` (dispatch
  thread) builds the device page the chunk trains on, taking the rows of
  clients the previous chunk updated from that chunk's output page on the
  card (``torch.where(use, ef_gather(prev, src), staged)``, so K6 runs
  here too); ``complete`` (dispatch thread) copies the chunk's output
  page to the host behind a CUDA event and hands the rows to a
  :class:`WritebackLane`.  Staging waits only for write-backs through
  chunk j-2, so gather, write-back and training overlap; the j-1 window
  is closed by the patch.  With a run log, each gather records an
  ``ef.page.gather`` span (prefetch thread) and each write-back an
  ``ef.page.writeback`` span (the lane's thread).

A paged run equals the dense run bit for bit: page rows hold the dense
rows' exact values, and virtual ids keep ids unique within a round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.engine.pipeline import WritebackLane
from repro_torch.kernels import ops
from repro_torch.obs.runlog import as_runlog

__all__ = ["HostEFStore", "PagePlan", "plan_chunk_static", "EFPager"]


class HostEFStore:
    """Host-resident per-client EF rows, keyed by client id.

    ``template`` is the per-client EF state (``uplink.init_state()``: one
    tensor per leaf, or None for a stateless leaf; only tensors are
    stored).  An absent client is the all-zero row, so ``from_dense``
    drops zero rows and an untrained federation costs no host memory.
    """

    def __init__(self, template):
        leaves = [z for z in template if z is not None]
        self._shapes = [tuple(z.shape) for z in leaves]
        self._dtypes = [np.dtype(str(z.dtype).replace("torch.", ""))
                        for z in leaves]
        self._rows: Dict[int, List[np.ndarray]] = {}
        self.hits = 0            # page rows served from a stored row
        self.misses = 0          # page rows that were implicit zeros
        self.writeback_rows = 0  # rows written back across the run

    @property
    def n_rows(self) -> int:
        return len(self._rows)

    @property
    def n_leaves(self) -> int:
        return len(self._shapes)

    def row_nbytes(self) -> int:
        """Bytes of one client's row over all leaves (the O(C·n) unit)."""
        return sum(int(np.prod(s, dtype=np.int64)) * d.itemsize
                   for s, d in zip(self._shapes, self._dtypes))

    def gather(self, cids, buffers: List[np.ndarray], rows) -> None:
        """Fill row ``rows[i]`` of every (zeroed) leaf buffer with client
        ``cids[i]``'s stored row; a miss leaves the zeros."""
        for cid, ri in zip(np.asarray(cids).tolist(),
                           np.asarray(rows).tolist()):
            stored = self._rows.get(cid)
            if stored is None:
                self.misses += 1
                continue
            self.hits += 1
            for buf, leaf in zip(buffers, stored):
                buf[ri] = leaf

    def update(self, cids, buffers: List[np.ndarray], rows) -> None:
        """Store client ``cids[i]``'s row from row ``rows[i]`` of every
        leaf buffer (copied: a view would pin the whole page)."""
        for cid, ri in zip(np.asarray(cids).tolist(),
                           np.asarray(rows).tolist()):
            self._rows[cid] = [np.array(buf[ri]) for buf in buffers]
        self.writeback_rows += len(cids)

    def to_dense(self, n_clients: int) -> List[np.ndarray]:
        """The compact ``[N, ...]`` arrays (the ``ef.npz`` layout)."""
        leaves = [np.zeros((n_clients,) + s, d)
                  for s, d in zip(self._shapes, self._dtypes)]
        for cid, stored in self._rows.items():
            for arr, leaf in zip(leaves, stored):
                arr[cid] = leaf
        return leaves

    def from_dense(self, dense) -> None:
        """Load from compact ``[N, ...]`` leaves (arrays or tensors),
        keeping only the non-zero rows."""
        leaves = [x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in dense if x is not None]
        nonzero = np.zeros(leaves[0].shape[0], bool)
        for arr in leaves:
            nonzero |= arr.reshape(arr.shape[0], -1).any(axis=1)
        self._rows.clear()
        for cid in np.nonzero(nonzero)[0].tolist():
            self._rows[cid] = [np.array(arr[cid]) for arr in leaves]


@dataclass(frozen=True)
class PagePlan:
    """One chunk's client -> page-slot assignment (host-side).

    ``vcids [K, C]`` replace the real ids as the superstep's ``cids``;
    ``uniq`` / ``slots`` / ``rows`` give each distinct client its slot and
    its row in the staged page.  ``page_rows = p_loc = K*C`` (one device).
    """

    index: int            # chunk sequence number (-1: calibration)
    cids: np.ndarray      # [K, C] real client ids
    vcids: np.ndarray     # [K, C] int32 virtual (page-relative) ids
    uniq: np.ndarray      # distinct real ids (sorted)
    slots: np.ndarray     # slot of each uniq entry
    rows: np.ndarray      # page row of each uniq entry
    p_loc: int
    n_shards: int
    page_rows: int


def plan_chunk_static(cids, n_shards: int = 1, *, index: int = -1
                      ) -> PagePlan:
    """Give every distinct client of ``cids [K, C]`` a page slot.

    A pure function of ``cids`` (chunk-size calibration builds throwaway
    plans through it).  A client sampled in several rounds of the chunk
    keeps one slot; distinct clients get distinct slots.  Only the
    single-device layout is ported (``n_shards == 1``; the sharded page
    with its scratch rows comes with the multi-GPU slice).
    """
    if n_shards != 1:
        raise NotImplementedError(
            "the sharded EF page comes with the multi-GPU slice "
            "(ROADMAP Queue 1, slice 5)")
    cids = np.asarray(cids)
    k, c = cids.shape
    p_loc = k * c
    flat = cids.reshape(-1)
    uniq = np.unique(flat)
    slots = np.arange(len(uniq), dtype=np.int64)
    vcids = slots[np.searchsorted(uniq, flat)].reshape(k, c).astype(np.int32)
    return PagePlan(index=index, cids=cids, vcids=vcids, uniq=uniq,
                    slots=slots, rows=slots, p_loc=p_loc, n_shards=1,
                    page_rows=p_loc)


def _patch_map(prev: PagePlan, cur: PagePlan):
    """``use [page_rows]`` marks rows of ``cur``'s page whose client the
    previous chunk updated; ``src`` holds that client's slot in the
    previous page."""
    use = np.zeros(cur.page_rows, bool)
    src = np.zeros(cur.page_rows, np.int32)
    prev_slot = dict(zip(prev.uniq.tolist(), prev.slots.tolist()))
    for cid, row in zip(cur.uniq.tolist(), cur.rows.tolist()):
        j = prev_slot.get(cid)
        if j is not None:
            use[row] = True
            src[row] = j
    return use, src


def _host_copy(tensors):
    """Host copies of device tensors and an event after them (pinned,
    non-blocking on the card); plain clones on the CPU."""
    if tensors[0].device.type != "cuda":
        return [t.clone() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class EFPager:
    """Prefetch-ahead staging and asynchronous write-back of cohort EF
    pages (chunk index j, in dispatch order):

    * ``stage(j)`` — prefetch thread — waits until write-backs through
      chunk j-2 completed, then gathers chunk j's rows from the store into
      a zeroed host page.  Rows chunk j-1 updates may be stale here; all
      of them are patched below.
    * ``patch(j)`` — dispatch thread — writes the page chunk j trains on
      into ``out`` (the captured graph's static page): the staged rows,
      with the rows of clients chunk j-1 trained taken from chunk j-1's
      output page on the card.
    * ``complete(j)`` — dispatch thread — records chunk j's output page as
      the next patch source, copies it to the host behind an event, and
      submits the write-back to the lane (the worker waits on the event).

    ``close()`` wakes a waiting ``stage`` (which raises) and runs the
    pending write-backs, so a final ``flush`` still sees a settled store.
    """

    def __init__(self, store: HostEFStore, device, *, runlog=None):
        self._store = store
        self._device = torch.device(device)
        self._rl = as_runlog(runlog)
        self._lane = WritebackLane(name="engine-ef-writeback", runlog=runlog)
        self._prev = None          # (PagePlan, output page on the device)
        self._stage_count = 0
        self.patched_rows = 0
        self.page_rows_max = 0

    @property
    def store(self) -> HostEFStore:
        return self._store

    @property
    def stall_s(self) -> float:
        return self._lane.stall_s

    # -- staging (prefetch thread) -------------------------------------
    def zero_page(self, plan: PagePlan, *, pool=None) -> List[np.ndarray]:
        """Zeroed host page leaf buffers for ``plan`` (pool-reusable)."""
        bufs = []
        for li, (s, d) in enumerate(zip(self._store._shapes,
                                        self._store._dtypes)):
            shape = (plan.page_rows,) + s
            buf = (pool.take(f"ef_page/{li}", shape, d) if pool is not None
                   else np.empty(shape, d))
            buf[...] = 0
            bufs.append(buf)
        return bufs

    def stage(self, cids, *, pool=None):
        """Chunk ``cids``'s (plan, host page leaves), ordered after the
        write-backs it depends on."""
        index = self._stage_count
        self._stage_count += 1
        if index >= 2 and not self._lane.wait_done(index - 1):
            raise RuntimeError(f"EF pager closed while staging chunk {index}")
        with self._rl.span("ef.page.gather", chunk=index,
                           rows=int(np.asarray(cids).size)):
            plan = plan_chunk_static(cids, index=index)
            bufs = self.zero_page(plan, pool=pool)
            self._store.gather(plan.uniq, bufs, plan.rows)
        self.page_rows_max = max(self.page_rows_max, plan.page_rows)
        return plan, bufs

    # -- device patch (dispatch thread) --------------------------------
    def patch(self, plan: PagePlan, staged: List[torch.Tensor],
              out: List[torch.Tensor]) -> None:
        """Write the page ``plan``'s chunk trains on into ``out``:
        ``staged`` (the host page, on the device) with the previous
        chunk's fresh rows selected in."""
        if self._prev is None:
            for o, s in zip(out, staged):
                o.copy_(s)
            return
        prev_plan, prev_page = self._prev
        use, src = _patch_map(prev_plan, plan)
        self.patched_rows += int(use.sum())
        use = torch.from_numpy(use).to(self._device)
        src = torch.from_numpy(src).to(self._device)
        for o, p, s in zip(out, prev_page, staged):
            m = use.reshape((-1,) + (1,) * (s.dim() - 1))
            o.copy_(torch.where(m, ops.ef_gather(p, src), s))

    # -- write-back (dispatch thread submits, lane worker runs) --------
    def complete(self, plan: PagePlan, out_page: List[torch.Tensor]) -> None:
        """Record chunk ``plan``'s output page and write its rows back."""
        self._prev = (plan, out_page)
        host, event = _host_copy(out_page)
        store, rl = self._store, self._rl

        def writeback():
            with rl.span("ef.page.writeback", chunk=plan.index,
                         rows=len(plan.uniq)):
                if event is not None:
                    event.synchronize()
                store.update(plan.uniq, [h.numpy() for h in host], plan.rows)

        self._lane.submit(writeback)

    def flush(self) -> None:
        """Wait until every submitted write-back landed in the store."""
        self._lane.flush()

    def close(self) -> None:
        self._lane.close()
