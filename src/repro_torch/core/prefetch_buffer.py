"""Paged device buffer for prefetched IVF clusters, backed by the shared
``DevicePagePool``.

The paper's pinned-CPU -> GPU prefetch buffer (Appendix D): cluster
pages live in the replica-wide device slab owned by
``repro_torch.memory.pool.DevicePagePool``; this class keeps the
*cluster* view — which clusters are resident, in which page slots (their
block tables), which waves have them pinned — and moves the pages.

The copy is really asynchronous on a CUDA device.  The datastore's pages
are kept once in pinned host memory (in the pool's dtype, bf16), where
each cluster's pages are contiguous; each page's ids and cluster are
kept on the device.  On a side stream, every new cluster's slice of the
pinned pages is copied ``non_blocking`` into a device scratch, and one
scatter writes the scratch, the gathered ids and clusters into their
slots; a ``torch.cuda.Event`` marks the end.  Nothing is gathered or
allocated on the host but the round's small slot index.  The side
stream first waits for work already queued on the compute stream (an
earlier search may still read slots being rewritten), and the compute
stream waits on the event (``wait_copies``, a device-side wait) before
the next search reads the slab, so decode steps queued in between
overlap the copy.  On a CPU device the same writes run synchronously.

Consistency invariants:
  * a device slot always holds a whole, un-corrupted page of exactly one
    cluster (page granularity transfers);
  * eviction is host bookkeeping + queued device invalidation — a slot is
    never searchable once its cluster was evicted (no duplicate results
    after refetch into different slots);
  * a cluster pinned by an in-flight wave is never evicted from under it
    (release happens on the wave's completion event);
  * transfers are counted in bytes for the budget/telemetry layer, and an
    invalidation-only scatter is NOT a transfer round (zero new pages
    moved means zero H2D rounds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.datastore import PagedClusters
from repro_torch.memory.pool import DevicePagePool, PageLease, Reservation


def host_pages(paged: PagedClusters, dtype: torch.dtype,
               pin: bool) -> torch.Tensor:
    """The datastore's pages [T, ps, d] as one host tensor in ``dtype``,
    pinned when ``pin`` — converted once per (datastore, dtype, pin) and
    kept on the ``PagedClusters``."""
    store = paged.__dict__.setdefault("_host_pages", {})
    key = (dtype, pin)
    if key not in store:
        src = torch.from_numpy(paged.pages)
        store[key] = torch.empty(src.shape, dtype=dtype,
                                 pin_memory=pin).copy_(src)
    return store[key]


@dataclass
class TransferStats:
    bytes_h2d: int = 0
    pages_h2d: int = 0
    rounds: int = 0

    def add(self, pages: int, page_bytes: int):
        self.pages_h2d += pages
        self.bytes_h2d += pages * page_bytes
        self.rounds += 1


class PrefetchBuffer:
    def __init__(self, paged: PagedClusters, num_pages: Optional[int] = None,
                 dtype=torch.bfloat16, *, pool: Optional[DevicePagePool] = None,
                 quota_pages: Optional[int] = None, device="cuda"):
        """``pool=None`` builds a private pool of ``num_pages`` slots on
        ``device``; with a pool, the pool's device is used."""
        if pool is None:
            if num_pages is None:
                raise ValueError("need num_pages or a pool")
            pool = DevicePagePool(paged, num_pages, dtype, device=device)
        self.paged = paged
        self.pool = pool
        # the datastore's pages, once, in the pool's dtype (pinned for a
        # card), and each page's ids and cluster on the device: made here
        # so that the conversion is set-up, not a round
        self._host = host_pages(paged, pool.dtype,
                                pin=pool.device.type == "cuda")
        self._tables = tuple(torch.from_numpy(a).to(pool.device, torch.int32)
                             for a in (paged.page_ids, paged.page_cluster))
        # the prefetch share of the pool (cache quotas key off this, not
        # the slab extent, so pool size never changes cache behaviour)
        self.quota_pages = (quota_pages if quota_pages is not None
                            else pool.num_pages)
        # host mirrors / page table
        self.slot_cluster = np.full(pool.num_pages, -1, np.int64)
        self.resident: Dict[int, List[int]] = {}
        self._leases: Dict[int, PageLease] = {}          # cluster -> lease
        self._pins: Dict[object, List[PageLease]] = {}   # wave key -> leases
        self._pending_invalid: Set[int] = set()
        self.stats = TransferStats()
        # CUDA copy state: side stream, end events of the copies not yet
        # waited on by the compute stream, and (start, end, nbytes) of
        # every copy for timing
        self._stream: Optional[torch.cuda.Stream] = None
        self._inflight: List[torch.cuda.Event] = []
        self.copies: List[Tuple[torch.cuda.Event, torch.cuda.Event, int]] = []
        self.last_event: Optional[torch.cuda.Event] = None

    # -- capacity ----------------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    @property
    def pages(self) -> torch.Tensor:
        return self.pool.pages

    @property
    def page_ids(self) -> torch.Tensor:
        return self.pool.page_ids

    @property
    def page_cluster(self) -> torch.Tensor:
        return self.pool.page_cluster

    @property
    def page_nbytes(self) -> int:
        return self.paged.page_nbytes()

    @property
    def capacity_bytes(self) -> int:
        return self.pool.capacity_bytes

    @property
    def used_pages(self) -> int:
        return self.pool.used_pages

    def free_pages(self) -> int:
        return self.pool.free_pages()

    def resident_clusters(self) -> Set[int]:
        return set(self.resident)

    def is_resident(self, cluster: int) -> bool:
        return cluster in self.resident

    # -- pinning (waves hold their working set until completion) -----------
    def pin_clusters(self, key: object,
                     clusters: Sequence[int]) -> List[PageLease]:
        """Take a reference on each resident cluster for wave ``key`` so
        spill/eviction cannot reclaim it while the wave is in flight.
        Returns the leases pinned (for a targeted ``release_pins``)."""
        pinned = self._pins.setdefault(key, [])
        taken: List[PageLease] = []
        for c in clusters:
            lease = self._leases.get(int(c))
            if lease is not None:
                self.pool.retain(lease)
                pinned.append(lease)
                taken.append(lease)
        return taken

    def release_pins(self, key: object, leases: Sequence[PageLease]) -> None:
        """Drop exactly these previously-taken pins for wave ``key`` (a
        parked wave must not hold its tentative hit pins — other parked
        waves would mutually wait on them)."""
        held = self._pins.get(key, [])
        for lease in leases:
            held.remove(lease)
            if lease.lease_id in self.pool.leases:
                self.pool.release(lease)

    def unpin(self, key: object) -> int:
        """Drop wave ``key``'s references; returns pages made evictable."""
        pages = 0
        for lease in self._pins.pop(key, []):
            if lease.lease_id in self.pool.leases:   # force-evict already
                pages += lease.num_pages if lease.refcount == 2 else 0
                self.pool.release(lease)             # dropped stale pins
        return pages

    def pinned_clusters(self) -> Set[int]:
        return {c for c, l in self._leases.items() if l.refcount > 1}

    def _own_lease_ids(self, key: object) -> Set[int]:
        """Lease ids pinned under ``key`` — a single pin key, or a
        tuple/list/set of keys (a continuous-batching wave's view is
        the union of its member requests' pins)."""
        if key is None:
            return set()
        if isinstance(key, (tuple, list, set, frozenset)):
            own: Set[int] = set()
            for k in key:
                own.update(l.lease_id for l in self._pins.get(k, ()))
            return own
        return {l.lease_id for l in self._pins.get(key, ())}

    def reclaimable_split(self, key: object,
                          hit_clusters: Sequence[int] = (),
                          ) -> Tuple[int, int]:
        """(waitable, spillable) page counts from wave ``key``'s view:
        *waitable* pages are pinned by other in-flight waves (their
        completion events release them — legitimate stall targets),
        *spillable* pages are unpinned residency evictable right now.
        The wave's own pins and the given ``hit_clusters`` (residency
        the wave is about to pin as its device hits) count as neither.
        ``key`` may be one pin key or a collection of per-request pin
        keys (the wave's members under continuous batching)."""
        own = self._own_lease_ids(key)
        hits = {int(c) for c in hit_clusters}
        waitable = spillable = 0
        for c, lease in self._leases.items():
            if lease.lease_id in own or c in hits:
                continue
            if lease.refcount > 1:
                waitable += lease.num_pages
            else:
                spillable += lease.num_pages
        return waitable, spillable

    def pages_pinned_by_others(self, key: object) -> int:
        """Pages pinned by in-flight waves other than ``key``."""
        return self.reclaimable_split(key)[0]

    # -- load --------------------------------------------------------------
    def load_clusters(self, clusters: Sequence[int], *,
                      reservation: Optional[Reservation] = None,
                      ) -> Tuple[List[int], List[int]]:
        """Fetch whole clusters into pool slots. Returns (loaded, rejected).

        Rejected = the pool cannot lease the *whole* cluster (admission
        should have reserved headroom; kept as a hard guarantee).
        """
        loaded: List[int] = []
        rejected: List[int] = []
        slot_list: List[int] = []
        spans: List[Tuple[int, int]] = []  # (first datastore page, pages)
        for c in clusters:
            c = int(c)
            if c in self.resident:
                loaded.append(c)
                continue
            npg = int(self.paged.cluster_num_pages[c])
            lease = self.pool.lease_slots(npg, "prefetch", tag=c,
                                          reservation=reservation)
            if lease is None:
                rejected.append(c)
                continue
            slots = list(lease.slots)
            self.resident[c] = slots
            self._leases[c] = lease
            self.slot_cluster[slots] = c
            self._pending_invalid.difference_update(slots)
            slot_list.extend(slots)
            spans.append((int(self.paged.cluster_first_page[c]), npg))
            loaded.append(c)

        # fold queued invalidations into the same write
        invalid = sorted(self._pending_invalid)
        self._pending_invalid.clear()

        if slot_list or invalid:
            self._write(slot_list, spans, invalid)
            if slot_list:          # invalidation-only flushes move no bytes
                self.stats.add(len(slot_list), self.page_nbytes)
        return loaded, rejected

    def _write(self, slots: List[int], spans: List[Tuple[int, int]],
               invalid: List[int]) -> None:
        """Copy the datastore pages of ``spans`` (each cluster's first
        page and page count, in slot order) into pool ``slots`` and clear
        the ``invalid`` slots (ids and cluster -1, zero vectors).
        Asynchronous on CUDA (see the module docstring)."""
        pool = self.pool
        dev = pool.device
        cuda = dev.type == "cuda"
        n = len(slots)
        src = [p for first, npg in spans for p in range(first, first + npg)]
        idx = torch.tensor(slots + invalid + src, dtype=torch.long)
        if cuda:
            idx = idx.pin_memory()

        def write():
            ix = idx.to(dev, non_blocking=True)
            if n:
                pages = torch.empty((n,) + tuple(self._host.shape[1:]),
                                    dtype=pool.dtype, device=dev)
                off = 0
                for first, npg in spans:
                    pages[off:off + npg].copy_(self._host[first:first + npg],
                                               non_blocking=True)
                    off += npg
                src_ix = ix[n + len(invalid):]
                ids, cl = (t.index_select(0, src_ix) for t in self._tables)
                pool.scatter(ix[:n], pages, ids, cl)
            if invalid:
                dead = ix[n:n + len(invalid)]
                pool.pages.index_fill_(0, dead, 0)
                pool.page_ids.index_fill_(0, dead, -1)
                pool.page_cluster.index_fill_(0, dead, -1)

        if not cuda:
            write()
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        # slots being rewritten may still be read by work already queued
        # on the compute stream (an earlier search)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            write()
            end.record()
        self._inflight.append(end)
        self.copies.append((start, end, n * self.page_nbytes))
        self.last_event = end

    def wait_copies(self) -> None:
        """Make the compute stream wait (on the device, no host sync) for
        every copy issued so far; the next kernel reading the slab sees
        the landed pages."""
        if not self._inflight:
            return
        cur = torch.cuda.current_stream(self.pool.device)
        for event in self._inflight:
            cur.wait_event(event)
        self._inflight.clear()

    # -- evict -------------------------------------------------------------
    def evict_clusters(self, clusters: Sequence[int], *,
                       force: bool = False) -> int:
        """Host-side free + queued device invalidation. Returns pages freed.

        A cluster pinned by an in-flight wave is skipped unless ``force``
        (its pages belong to that wave until its completion event).
        """
        freed = 0
        for c in clusters:
            c = int(c)
            lease = self._leases.get(c)
            if lease is None:
                continue
            if lease.refcount > 1 and not force:
                continue
            slots = self.resident.pop(c)
            del self._leases[c]
            self.slot_cluster[slots] = -1
            self._pending_invalid.update(slots)
            while lease.lease_id in self.pool.leases:
                self.pool.release(lease)   # force: strip remaining pins too
            freed += len(slots)
        return freed

    def flush_invalidations(self) -> None:
        """Force queued invalidations to the device (normally folded into
        the next load; needed before a search with no intervening load).
        Moves zero new pages, so it never counts as a transfer round."""
        if self._pending_invalid:
            self.load_clusters([])

    # -- views for the search kernel ----------------------------------------
    def device_view(self):
        return self.pool.device_view()
