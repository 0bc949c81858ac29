"""Cohort-paged error-feedback store (port of ``repro/engine/efstore.py``):
O(C·n) device memory at any federation size N.

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

On a mesh (``EFPager(mesh=...)``, S client ranks) a client's slot lives on
its owner rank, ``cid % S``, stable across chunks, so the device patch
never crosses ranks.  The page keeps the resident scratch-row layout
(``[(P_loc+1)*S, n]`` over the ranks, ``P_loc = K*C``): each rank stages,
patches and writes back only its own ``[P_loc+1, n]`` block, and its host
store holds only the rows it owns.  The engine assembles the whole
``[N, n]`` on rank 0 for a checkpoint (:meth:`HostEFStore.export_rows` /
:meth:`HostEFStore.merge_rows`).
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

    def from_dense(self, dense, *, n_shards: int = 1,
                   position: int = 0) -> None:
        """Load from compact ``[N, ...]`` leaves (arrays or tensors),
        keeping only the non-zero rows; on a mesh only those rank
        ``position`` of ``n_shards`` owns (``cid % n_shards``)."""
        leaves = [x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in dense if x is not None]
        keep = np.zeros(leaves[0].shape[0], bool)
        for arr in leaves:
            keep |= arr.reshape(arr.shape[0], -1).any(axis=1)
        keep &= np.arange(len(keep)) % n_shards == position
        self._rows.clear()
        for cid in np.nonzero(keep)[0].tolist():
            self._rows[cid] = [np.array(arr[cid]) for arr in leaves]

    def export_rows(self) -> Dict[int, List[np.ndarray]]:
        """The stored rows, by client id (what one rank sends for a
        checkpoint)."""
        return dict(self._rows)

    def merge_rows(self, rows: Dict[int, List[np.ndarray]]) -> None:
        """Take another rank's :meth:`export_rows` (owners are disjoint)."""
        self._rows.update(rows)


@dataclass(frozen=True)
class PagePlan:
    """One chunk's client -> page-slot assignment (host-side).

    ``vcids [K, C]`` replace the real ids as the superstep's ``cids``;
    ``uniq`` / ``slots`` / ``rows`` give each distinct client its slot in
    its owner's block and its row in the whole staged page.  ``page_rows``
    is ``p_loc = K*C`` on one device, ``(p_loc + 1) * n_shards`` on a
    mesh.
    """

    index: int            # chunk sequence number (-1: calibration)
    cids: np.ndarray      # [K, C] real client ids
    vcids: np.ndarray     # [K, C] int32 virtual (page-relative) ids
    uniq: np.ndarray      # distinct real ids (sorted)
    slots: np.ndarray     # block-local slot of each uniq entry
    rows: np.ndarray      # page row of each uniq entry
    p_loc: int
    n_shards: int
    page_rows: int


def plan_chunk_static(cids, n_shards: int = 1, *, index: int = -1
                      ) -> PagePlan:
    """Give every distinct client of ``cids [K, C]`` a page slot.

    A pure function of ``(cids, n_shards)`` (chunk-size calibration builds
    throwaway plans through it).  A client sampled in several rounds of
    the chunk keeps one slot; distinct clients get distinct slots.  With
    ``n_shards > 1`` a client's slot lives in its owner's block (rank
    ``cid % n_shards``), each block followed by its scratch row.
    """
    cids = np.asarray(cids)
    k, c = cids.shape
    p_loc = k * c
    flat = cids.reshape(-1)
    uniq = np.unique(flat)
    if n_shards == 1:
        slots = np.arange(len(uniq), dtype=np.int64)
        v = rows = slots
        page_rows = p_loc
    else:
        owner = uniq % n_shards
        slots = np.empty(len(uniq), np.int64)
        v = np.empty(len(uniq), np.int64)
        rows = np.empty(len(uniq), np.int64)
        for s in range(n_shards):
            idx = np.nonzero(owner == s)[0]
            slots[idx] = np.arange(len(idx))
            v[idx] = s * p_loc + slots[idx]
            rows[idx] = s * (p_loc + 1) + slots[idx]
        page_rows = (p_loc + 1) * n_shards
    # uniq is sorted: searchsorted maps every sampled id to its entry
    vcids = v[np.searchsorted(uniq, flat)].reshape(k, c).astype(np.int32)
    return PagePlan(index=index, cids=cids, vcids=vcids, uniq=uniq,
                    slots=slots, rows=rows, p_loc=p_loc, n_shards=n_shards,
                    page_rows=page_rows)


def _patch_map(prev: PagePlan, cur: PagePlan):
    """``use [page_rows]`` marks rows of ``cur``'s page whose client the
    previous chunk updated; ``src`` holds that client's block-local slot
    in the previous page (owners are stable, so source and destination
    lie in the same rank's block)."""
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
    ``mesh`` (or the engine's ``shard``): this rank's block only (module
    docstring).
    """

    def __init__(self, store: HostEFStore, device, *, mesh=None,
                 shard=None, runlog=None):
        self._store = store
        self._device = torch.device(device)
        self._rl = as_runlog(runlog)
        self.n_shards, self.position = 1, 0
        if shard is not None:        # a ClientSharding (the engine's)
            self.n_shards, self.position = shard.n_shards, shard.position
        elif mesh is not None:
            from repro_torch.launch.mesh import client_position
            _, sizes, position = client_position(mesh)
            self.n_shards = int(np.prod(sizes, dtype=np.int64))
            self.position = position if self.n_shards > 1 else 0
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

    def _block_rows(self, plan: PagePlan) -> int:
        """Rows of this rank's block of ``plan``'s page."""
        return plan.page_rows // self.n_shards

    def _mine(self, plan: PagePlan):
        """(ids, block-local slots) of the clients this rank owns."""
        if self.n_shards == 1:
            return plan.uniq, plan.slots
        mine = plan.uniq % self.n_shards == self.position
        return plan.uniq[mine], plan.slots[mine]

    def _block(self, x, plan: PagePlan):
        """This rank's block of a per-page-row array."""
        n = self._block_rows(plan)
        return x[self.position * n:(self.position + 1) * n]

    # -- staging (prefetch thread) -------------------------------------
    def zero_page(self, plan: PagePlan, *, pool=None) -> List[np.ndarray]:
        """Zeroed host leaf buffers of this rank's block of ``plan``'s page
        (pool-reusable)."""
        bufs = []
        for li, (s, d) in enumerate(zip(self._store._shapes,
                                        self._store._dtypes)):
            shape = (self._block_rows(plan),) + s
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
            plan = plan_chunk_static(cids, self.n_shards, index=index)
            bufs = self.zero_page(plan, pool=pool)
            ids, slots = self._mine(plan)
            self._store.gather(ids, bufs, slots)
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
        use, src = (self._block(x, plan) for x in _patch_map(prev_plan, plan))
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
                ids, slots = self._mine(plan)
                store.update(ids, [h.numpy() for h in host], slots)

        self._lane.submit(writeback)

    def flush(self) -> None:
        """Wait until every submitted write-back landed in the store."""
        self._lane.flush()

    def close(self) -> None:
        self._lane.close()
