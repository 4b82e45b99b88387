"""Shared HBM page pool: one slab allocator for every device-memory
consumer of a replica.

TeleRAG's premise is serving RAG *under limited GPU memory*, so carving
HBM into per-subsystem islands (a fixed prefetch slab here, an ad-hoc
KV pool there) wastes exactly the resource the paper economizes.  The
``DevicePagePool`` is the single arbiter: a slab of ``num_pages``
fixed-size device page slots plus a host-side free list, handed out as
refcounted **leases** (vLLM-style block tables — a lease's ``slots``
are its block table, in allocation order, not necessarily contiguous).

Two lease classes share the one free list:

  * **slot leases** (``lease_slots``) — cluster pages for the prefetch
    buffer; their payload is written by ``scatter`` (one ``index_copy_``
    per slab tensor), which the prefetch buffer issues on its copy
    stream right behind the host-to-device copy;
  * **byte leases** (``lease_bytes``) — KV/decode caches; their tensors
    live outside the slab but their HBM footprint is charged here by
    taking whole page slots out of circulation (``page_cluster`` stays
    -1, so the search kernels never see them).

**Reservations** let an admission controller promise headroom to a wave
before any page is touched: ``reserve()`` subtracts from
``reservable_pages()`` without moving slots; allocation under the
reservation consumes it; ``cancel()`` returns the unused remainder.

**Tenant shares** make the pool multi-tenant: each lease/reservation is
tagged with the tenant it serves, and ``set_tenant_share`` registers a
guaranteed page *floor* (held back from every other tenant while
unclaimed) plus an optional *burst cap* (``max_pages``).  With no
shares registered every tenant sees the legacy single-tenant pool —
``reservable_pages_for`` degrades to ``reservable_pages`` exactly.

Every alloc/free is mirrored into the replica's ``MemoryLedger`` (exact
bytes, not page-rounded, when the caller knows them) and broadcast to
``subscribe``d listeners — the runtime turns those callbacks into
page-free events that wake ``PRESSURE_STALLED`` requests.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.datastore import PagedClusters
from repro_torch.memory.ledger import MemoryLedger
from repro_torch.obs.recorder import FlightRecorder, PoolEvent


class PoolExhausted(RuntimeError):
    """Raised when a caller demands pages the pool cannot supply.

    ``bytes_needed`` > 0 marks a *pool-bytes* shortfall — one that
    evicting cold unpinned prefetch residency could cure (the runtime
    spills toward it before shedding a decode wave).  Structural
    exhaustion (e.g. a KV slab's free list) leaves it 0: no eviction
    can help, only a future release."""

    def __init__(self, msg: str, *, bytes_needed: int = 0):
        super().__init__(msg)
        self.bytes_needed = bytes_needed


@dataclass(eq=False)
class PageLease:
    """A refcounted hold on pool pages. ``slots`` is the block table."""

    lease_id: int
    owner: str                       # ledger category: "prefetch" | "kv" | ...
    slots: Tuple[int, ...]
    nbytes: int                      # exact bytes charged to the ledger
    tag: object = None               # caller-meaningful id (cluster, request)
    refcount: int = 1
    tenant: str = "shared"           # tenant the pages are attributed to

    @property
    def num_pages(self) -> int:
        """Pages held by this lease (length of its block table)."""
        return len(self.slots)


@dataclass(eq=False)
class Reservation:
    """Admission headroom: pages promised but not yet allocated."""

    res_id: int
    owner: str
    pages: int                       # remaining unconsumed headroom
    tenant: str = "shared"           # tenant the headroom is charged to

    def __repr__(self) -> str:       # short form for event logs
        return (f"Reservation({self.res_id}, {self.owner!r}, "
                f"pages={self.pages}, tenant={self.tenant!r})")


@dataclass(frozen=True)
class TenantShare:
    """One tenant's pool entitlement (pages, not bytes).

    ``floor_pages`` is a guaranteed reservation floor: while the tenant
    holds fewer pages than its floor, the shortfall is withheld from
    every other tenant's reservable headroom, so the floor can always
    be claimed.  ``max_pages`` is the burstable cap — the most the
    tenant may hold in total (``None`` = may burst to the whole pool).
    """

    tenant: str
    floor_pages: int
    max_pages: Optional[int] = None


class DevicePagePool:
    """One replica's HBM slab allocator: ``num_pages`` fixed-size page
    slots handed out as refcounted leases (block tables), with
    admission reservations and per-tenant floors/caps layered on the
    same free list.  All byte quantities are exact bytes; all counts
    returned by ``*_pages`` methods are whole page slots."""

    def __init__(self, paged: PagedClusters, num_pages: int,
                 dtype=torch.bfloat16, *, ledger: Optional[MemoryLedger] = None,
                 device: DeviceLike = "cuda"):
        """Build a pool of ``num_pages`` device page slots over ``paged``
        (which fixes the page geometry and therefore ``page_nbytes``);
        ``ledger`` defaults to a fresh byte ledger sized to the slab.  The
        slab is three tensors on ``device``: ``pages`` [num_pages, ps, d]
        in ``dtype`` (bf16, so device scores round as the reference's
        do), ``page_ids`` [num_pages, ps] and ``page_cluster``
        [num_pages] int32."""
        self.paged = paged
        self.num_pages = num_pages
        self.dtype = dtype
        self.device = resolve_device(device)
        ps, d = paged.page_size, paged.dim
        self.pages = torch.zeros((num_pages, ps, d), dtype=dtype,
                                 device=self.device)
        self.page_ids = torch.full((num_pages, ps), -1, dtype=torch.int32,
                                   device=self.device)
        self.page_cluster = torch.full((num_pages,), -1, dtype=torch.int32,
                                       device=self.device)
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.ledger = ledger if ledger is not None else MemoryLedger(
            capacity_bytes=num_pages * self.page_nbytes)
        self.leases: Dict[int, PageLease] = {}
        self.reservations: Dict[int, Reservation] = {}
        self.tenant_shares: Dict[str, TenantShare] = {}
        # running per-tenant held-page counters (leases + unconsumed
        # reservations), maintained incrementally so reserve/lease stay
        # O(1) instead of scanning every lease per allocation
        self._tenant_held: Dict[str, int] = {}
        self._ids = itertools.count()
        self._subscribers: List[Callable[[int], None]] = []
        # flight-recorder lane (attached by the owning engine/server);
        # events are stamped at recorder.now — the pool has no clock
        self.recorder: Optional[FlightRecorder] = None
        self.replica_id = -1

    def _record(self, kind: str, owner: str, pages: int, nbytes: int,
                tenant: str) -> None:
        """Emit one allocation edge with post-op free/occupancy (the
        exporters' pool counter tracks read these)."""
        rec = self.recorder
        if rec is not None:
            rec.emit(PoolEvent(
                t=rec.now, kind=kind, replica=self.replica_id,
                tenant=tenant, owner=owner, pages=pages, nbytes=nbytes,
                free_pages=len(self.free),
                occupancy=self.ledger.occupancy()))

    def _bump_tenant(self, tenant: str, delta: int) -> None:
        if delta:
            self._tenant_held[tenant] = (self._tenant_held.get(tenant, 0)
                                         + delta)

    # -- capacity -----------------------------------------------------------
    @property
    def page_nbytes(self) -> int:
        """Bytes per page slot (fixed by the paged datastore geometry)."""
        return self.paged.page_nbytes()

    @property
    def capacity_bytes(self) -> int:
        """Total slab bytes (``num_pages * page_nbytes``)."""
        return self.num_pages * self.page_nbytes

    def free_pages(self) -> int:
        """Physically free slots (some may be spoken for by reservations)."""
        return len(self.free)

    @property
    def used_pages(self) -> int:
        """Slots currently out on leases (pages, not bytes)."""
        return self.num_pages - len(self.free)

    def reserved_pages(self) -> int:
        """Unconsumed headroom promised to outstanding reservations."""
        return sum(r.pages for r in self.reservations.values())

    def reservable_pages(self) -> int:
        """Free slots not already promised to an outstanding reservation."""
        return len(self.free) - self.reserved_pages()

    def leased_pages(self, owner: Optional[str] = None) -> int:
        """Pages out on leases, optionally filtered by ledger category."""
        return sum(l.num_pages for l in self.leases.values()
                   if owner is None or l.owner == owner)

    # -- tenant shares ------------------------------------------------------
    def set_tenant_share(self, tenant: str, floor_pages: int,
                         max_pages: Optional[int] = None) -> TenantShare:
        """Register (or replace) ``tenant``'s entitlement: a guaranteed
        ``floor_pages`` reservation floor plus an optional ``max_pages``
        burst cap.  The sum of floors must fit the pool."""
        share = TenantShare(tenant=tenant, floor_pages=int(floor_pages),
                            max_pages=(None if max_pages is None
                                       else int(max_pages)))
        if share.max_pages is not None and share.max_pages < share.floor_pages:
            raise ValueError(f"max_pages {share.max_pages} < floor "
                             f"{share.floor_pages} for tenant {tenant!r}")
        others = sum(s.floor_pages for t, s in self.tenant_shares.items()
                     if t != tenant)
        if others + share.floor_pages > self.num_pages:
            raise ValueError(
                f"tenant floors exceed the pool: {others} + "
                f"{share.floor_pages} > {self.num_pages} pages")
        self.tenant_shares[tenant] = share
        return share

    def tenant_pages(self, tenant: str) -> int:
        """Pages ``tenant`` currently holds: its live leases plus its
        outstanding (unconsumed) reservation headroom.  O(1) — read off
        the incrementally-maintained counter."""
        return self._tenant_held.get(tenant, 0)

    def tenant_bytes(self, tenant: str,
                     owner: Optional[str] = None) -> int:
        """Bytes of ``tenant``'s live leases, optionally filtered by
        ledger category (``owner="kv"`` = the tenant's decode-cache
        footprint — what ``ServerTelemetry.tenants`` surfaces)."""
        return sum(l.nbytes for l in self.leases.values()
                   if l.tenant == tenant
                   and (owner is None or l.owner == owner))

    def reattribute(self, lease: PageLease, tenant: str) -> PageLease:
        """Move a live lease's tenancy (held-page counters + ledger
        attribution) to ``tenant`` — how a recycled KV bucket's bytes
        follow the request that reuses it instead of staying charged to
        its first owner."""
        if lease.lease_id not in self.leases:
            raise KeyError(f"lease {lease.lease_id} is not live")
        if lease.tenant == tenant:
            return lease
        self._bump_tenant(lease.tenant, -lease.num_pages)
        self._bump_tenant(tenant, lease.num_pages)
        self.ledger.credit(lease.owner, lease.nbytes, tenant=lease.tenant)
        lease.tenant = tenant
        self.ledger.charge(lease.owner, lease.nbytes, tenant=tenant)
        return lease

    def withheld_floor_pages(self, tenant: str) -> int:
        """Pages held back from ``tenant``: the unclaimed part of every
        OTHER tenant's guaranteed floor (``max(0, floor - held)``)."""
        return sum(max(0, s.floor_pages - self.tenant_pages(t))
                   for t, s in self.tenant_shares.items() if t != tenant)

    def tenant_ceiling(self, tenant: str = "shared") -> int:
        """The most pages ``tenant`` could EVER reserve in one request,
        assuming every current holder releases: the pool minus other
        tenants' guaranteed floors, bounded by the tenant's own burst
        cap.  A request above this can never be granted — admission
        must cap it rather than park it waiting for frees that cannot
        suffice."""
        ceiling = self.num_pages - sum(
            s.floor_pages for t, s in self.tenant_shares.items()
            if t != tenant)
        share = self.tenant_shares.get(tenant)
        if share is not None and share.max_pages is not None:
            ceiling = min(ceiling, share.max_pages)
        return max(0, ceiling)

    def reservable_pages_for(self, tenant: str = "shared") -> int:
        """``reservable_pages`` as seen by ``tenant``: free slots minus
        outstanding reservations, minus other tenants' unclaimed floors,
        capped by the tenant's own burst cap.  With no shares registered
        this is exactly ``reservable_pages()``."""
        if not self.tenant_shares:
            return self.reservable_pages()
        avail = self.reservable_pages() - self.withheld_floor_pages(tenant)
        share = self.tenant_shares.get(tenant)
        if share is not None and share.max_pages is not None:
            avail = min(avail, share.max_pages - self.tenant_pages(tenant))
        return max(0, avail)

    def subscribe(self, cb: Callable[[int], None]) -> None:
        """``cb(pages_freed)`` fires whenever slots return to the free list."""
        self._subscribers.append(cb)

    def subscribers(self) -> Tuple[Callable[[int], None], ...]:
        """The registered page-free listeners (read-only view)."""
        return tuple(self._subscribers)

    def rebind_subscribers(self, source: "DevicePagePool") -> int:
        """Carry page-free listeners over from a replaced pool (replica
        restart): long-lived runtimes subscribed to the old pool keep
        receiving events from this one.  Returns how many were bound."""
        bound = 0
        for cb in source.subscribers():
            if cb not in self._subscribers:
                self._subscribers.append(cb)
                bound += 1
        return bound

    def _notify_freed(self, pages: int) -> None:
        if pages > 0:
            for cb in self._subscribers:
                cb(pages)

    # -- reservations -------------------------------------------------------
    def reserve(self, npages: int, owner: str,
                tenant: str = "shared") -> Optional[Reservation]:
        """Promise ``npages`` of headroom to ``owner`` on behalf of
        ``tenant`` (None = the tenant's view of the pool cannot cover
        it: free slots minus others' reservations and unclaimed floors,
        bounded by the tenant's burst cap)."""
        if npages > self.reservable_pages_for(tenant):
            return None
        res = Reservation(res_id=next(self._ids), owner=owner,
                          pages=int(npages), tenant=tenant)
        self.reservations[res.res_id] = res
        self._bump_tenant(tenant, int(npages))
        return res

    def cancel(self, res: Reservation) -> int:
        """Release a reservation's unconsumed headroom; returns it."""
        live = self.reservations.pop(res.res_id, None)
        if live is None:
            return 0
        remainder, live.pages = live.pages, 0
        self._bump_tenant(live.tenant, -remainder)
        self._notify_freed(remainder)
        return remainder

    # -- leases -------------------------------------------------------------
    def _take_slots(self, npages: int, reservation: Optional[Reservation],
                    tenant: str) -> Optional[List[int]]:
        if reservation is not None and reservation.res_id in self.reservations:
            headroom = self.reservable_pages_for(tenant) + reservation.pages
        else:
            reservation = None
            headroom = self.reservable_pages_for(tenant)
        if npages > headroom or npages > len(self.free):
            return None
        if reservation is not None:
            consumed = min(reservation.pages, npages)
            reservation.pages -= consumed
            self._bump_tenant(reservation.tenant, -consumed)
        return [self.free.pop() for _ in range(npages)]

    def lease_slots(self, npages: int, owner: str = "prefetch", *,
                    tag: object = None, nbytes: Optional[int] = None,
                    reservation: Optional[Reservation] = None,
                    tenant: Optional[str] = None) -> Optional[PageLease]:
        """Lease scatterable page slots (cluster pages). None = no room.
        ``tenant`` defaults to the reservation's tenant (a wave's lease
        inherits the tenancy its admission reserved under)."""
        if tenant is None:
            tenant = reservation.tenant if reservation is not None else "shared"
        slots = self._take_slots(npages, reservation, tenant)
        if slots is None:
            return None
        nb = npages * self.page_nbytes if nbytes is None else int(nbytes)
        lease = PageLease(lease_id=next(self._ids), owner=owner,
                         slots=tuple(slots), nbytes=nb, tag=tag,
                         tenant=tenant)
        self.leases[lease.lease_id] = lease
        self._bump_tenant(tenant, npages)
        self.ledger.charge(owner, nb, tenant=tenant)
        self._record("pool.lease", owner, npages, nb, tenant)
        return lease

    def lease_bytes(self, nbytes: int, owner: str = "kv", *,
                    tag: object = None,
                    reservation: Optional[Reservation] = None,
                    tenant: Optional[str] = None) -> Optional[PageLease]:
        """Charge an HBM footprint that lives outside the slab (KV cache):
        whole page slots leave circulation, the ledger is charged the
        exact byte count."""
        npages = -(-int(nbytes) // self.page_nbytes)
        return self.lease_slots(npages, owner, tag=tag, nbytes=int(nbytes),
                                reservation=reservation, tenant=tenant)

    def retain(self, lease: PageLease) -> PageLease:
        """Take one more reference on a live lease (wave pinning)."""
        if lease.lease_id not in self.leases:
            raise KeyError(f"lease {lease.lease_id} is not live")
        lease.refcount += 1
        return lease

    def release(self, lease: PageLease) -> int:
        """Drop one reference; at zero the slots return to the free list.
        Returns the number of pages freed (0 while references remain)."""
        if lease.lease_id not in self.leases:
            return 0
        lease.refcount -= 1
        if lease.refcount > 0:
            return 0
        del self.leases[lease.lease_id]
        self.free.extend(lease.slots)
        self._bump_tenant(lease.tenant, -lease.num_pages)
        self.ledger.credit(lease.owner, lease.nbytes, tenant=lease.tenant)
        self._record("pool.release", lease.owner, lease.num_pages,
                     lease.nbytes, lease.tenant)
        self._notify_freed(lease.num_pages)
        return lease.num_pages

    # -- device slab --------------------------------------------------------
    def scatter(self, slots: torch.Tensor, pages: torch.Tensor,
                page_ids: torch.Tensor, page_cluster: torch.Tensor) -> None:
        """Write whole pages into slab slots in place: one ``index_copy_``
        per slab tensor.  ``slots`` [n] int64, ``pages`` [n, ps, d],
        ``page_ids`` [n, ps], ``page_cluster`` [n], all on the slab's
        device.  Runs on the current stream (the prefetch buffer issues
        it on its copy stream)."""
        if slots.numel() == 0:
            return
        self.pages.index_copy_(0, slots, pages.to(self.dtype))
        self.page_ids.index_copy_(0, slots, page_ids)
        self.page_cluster.index_copy_(0, slots, page_cluster)

    def device_view(self):
        """The (pages, page_ids, page_cluster) device tensors the search
        kernels read (page_cluster -1 marks unsearchable slots)."""
        return self.pages, self.page_ids, self.page_cluster
