"""Admission control over the shared device page pool.

A wave's lookahead plan must *reserve* its page headroom up front; the
alternative — the planner silently clamping the plan to whatever slots
happen to be free — is exactly the failure mode the ROADMAP names ("the
planner stalls when a prior wave fills the buffer").  The controller
makes the reserve/stall/spill decision explicit:

  1. **reserve** — if the pool can promise the pages, hand back a
     ticket wrapping a ``Reservation``; allocation consumes it and
     ``commit()`` returns the unused remainder.
  2. **spill** — under pressure, first reclaim *evictable* pages (cold,
     unpinned cluster residency) through the spill hook, then retry the
     reservation.  Spilling is a recorded decision, not a side effect.
  3. **stall** — if pressure comes from pages that future events will
     free (another wave's pins, KV leases, outstanding reservations),
     return ``None``: the caller parks the wave ``PRESSURE_STALLED`` on
     the runtime's event queue and retries on page-free events.
  4. **cap** — when *nothing* outstanding will ever free pages (the
     plan simply exceeds the pool), grant what exists and mark the
     ticket ``capped`` so telemetry shows the shortfall.  This is the
     progress guarantee: a stall with no possible waker would deadlock.

Multi-tenant pools add two rules.  Admission is **tenant-scoped**: a
ticket reserves against ``pool.reservable_pages_for(tenant)``, so one
tenant's burst can never consume another tenant's unclaimed floor.  And
the spill hook is handed a **protect set**: residency belonging to
tenants at or under their guaranteed floor is never evicted to make
room for someone else's burst — spill victims come only from over-floor
(or untenanted) holders.

The controller never moves bytes itself; it only arbitrates the pool.
"""

from __future__ import annotations

import inspect
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.memory.pool import DevicePagePool, Reservation
from repro_torch.obs.recorder import AdmissionEvent, FlightRecorder


@dataclass
class AdmissionStats:
    """Counters for one admission domain (a replica, or one tenant's
    slice of it).  ``*_pages`` fields count whole page slots; the rest
    count admit() decisions."""

    admitted: int = 0                # tickets granted with full headroom
    stalled: int = 0                 # admit() refusals that parked a wave
    resumed: int = 0                 # parked waves re-admitted later
    capped: int = 0                  # tickets granted below the request
    spilled_pages: int = 0           # pages reclaimed by the spill hook
    shortfall_pages: int = 0         # requested-minus-granted across caps


@dataclass(eq=False)
class AdmissionTicket:
    """One granted admission: the wave may allocate up to its
    reservation (``pages_granted`` pages); ``commit()`` after dispatch
    returns the remainder.  ``tenant`` is who the pages are charged to."""

    ticket_id: int
    owner: str
    pages_requested: int
    pages_granted: int
    reservation: Optional[Reservation]
    capped: bool = False
    spilled_pages: int = 0
    tenant: str = "shared"


class AdmissionController:
    """Arbitrates the pool for wave admission: reserve / spill / stall /
    cap, with per-tenant floors honored and per-tenant stats kept next
    to the replica-wide ``stats``."""

    def __init__(self, pool: DevicePagePool, *,
                 spill: Optional[Callable[..., object]] = None):
        """``spill(target_free_pages, protect=None)`` should try to raise
        the pool's physically-free page count to the target by evicting
        cold, unpinned residency (best effort), skipping any cluster in
        ``protect`` (residency of tenants at/under their floor).  Hooks
        with the legacy single-argument signature are still accepted."""
        self.pool = pool
        self.spill = spill
        self._spill_takes_protect = False
        if spill is not None:
            try:
                params = inspect.signature(spill).parameters
                self._spill_takes_protect = (
                    "protect" in params
                    or any(p.kind is p.VAR_KEYWORD
                           for p in params.values()))
            except (TypeError, ValueError):
                pass
        self.stats = AdmissionStats()
        self.per_tenant: Dict[str, AdmissionStats] = {}
        self._ids = itertools.count()
        # parked waves: (key, pages_requested, tenant)
        self.parked: List[Tuple[object, int, str]] = []
        # flight-recorder lane (attached by the owning engine/server);
        # decisions are stamped at recorder.now — admit() takes no clock
        self.recorder: Optional[FlightRecorder] = None
        self.replica_id = -1

    def _record(self, kind: str, owner: str, requested: int, granted: int,
                tenant: str, *, wave_id: int = -1,
                spilled: int = 0) -> None:
        rec = self.recorder
        if rec is not None:
            rec.emit(AdmissionEvent(
                t=rec.now, kind=kind, replica=self.replica_id,
                tenant=tenant, wave_id=wave_id, owner=owner,
                pages_requested=requested, pages_granted=granted,
                spilled_pages=spilled))

    def _tstats(self, tenant: str) -> AdmissionStats:
        """The per-tenant stats slice (created on first touch)."""
        if tenant not in self.per_tenant:
            self.per_tenant[tenant] = AdmissionStats()
        return self.per_tenant[tenant]

    # -- decision -----------------------------------------------------------
    def admit(self, npages: int, owner: str, *, can_wait: bool = True,
              tenant: str = "shared",
              wave_id: int = -1) -> Optional[AdmissionTicket]:
        """Reserve ``npages`` of headroom for ``tenant``.  None = park
        and retry on a page-free event (only when ``can_wait`` and a
        future free is possible); otherwise the grant may be
        spilled-into or capped.  ``wave_id`` only correlates the
        decision's trace event with the requesting wave."""
        npages = int(npages)
        tstats = self._tstats(tenant)
        res = self.pool.reserve(npages, owner, tenant=tenant)
        spilled = 0
        if res is None and self.spill is not None and npages > 0:
            before = self.pool.free_pages()
            # target enough physical frees to cover others' reservations too
            self._run_spill(npages + self.pool.reserved_pages(), tenant)
            spilled = self.pool.free_pages() - before
            self.stats.spilled_pages += spilled
            tstats.spilled_pages += spilled
            res = self.pool.reserve(npages, owner, tenant=tenant)
            if spilled > 0:
                self._record("admission.spill", owner, npages, 0, tenant,
                             wave_id=wave_id, spilled=spilled)
        if res is None:
            # parking is only sound if a future free could EVER satisfy
            # the request — a plan above the tenant's reachable ceiling
            # (its burst cap / others' floors) must cap now, not starve
            # on page-free retries until the event heap drains
            reachable = npages <= self.pool.tenant_ceiling(tenant)
            if can_wait and reachable and self.holds_pending_release():
                self.stats.stalled += 1
                tstats.stalled += 1
                self._record("admission.stall", owner, npages, 0, tenant,
                             wave_id=wave_id)
                return None
            granted = max(0, self.pool.reservable_pages_for(tenant))
            res = (self.pool.reserve(granted, owner, tenant=tenant)
                   if granted else None)
            self.stats.capped += 1
            tstats.capped += 1
            self.stats.shortfall_pages += npages - granted
            tstats.shortfall_pages += npages - granted
            self._record("admission.cap", owner, npages, granted, tenant,
                         wave_id=wave_id, spilled=spilled)
            return AdmissionTicket(
                ticket_id=next(self._ids), owner=owner,
                pages_requested=npages, pages_granted=granted,
                reservation=res, capped=True, spilled_pages=spilled,
                tenant=tenant)
        self.stats.admitted += 1
        tstats.admitted += 1
        self._record("admission.admit", owner, npages, npages, tenant,
                     wave_id=wave_id, spilled=spilled)
        return AdmissionTicket(
            ticket_id=next(self._ids), owner=owner, pages_requested=npages,
            pages_granted=npages, reservation=res, spilled_pages=spilled,
            tenant=tenant)

    def _run_spill(self, target: int, tenant: str) -> None:
        """Invoke the spill hook with the floor-protect set (falling
        back to the legacy one-argument hook signature, detected once
        at construction)."""
        if self._spill_takes_protect:
            self.spill(target, protect=self.spill_protect(tenant))
        else:
            self.spill(target)

    def spill_protect(self, tenant: str) -> Optional[Set[object]]:
        """Cluster tags whose residency spill must NOT evict on behalf
        of ``tenant``: for every OTHER tenant with a guaranteed floor,
        enough of its prefetch residency (whole clusters, in lease
        order) to keep its held pages at or above the floor.  A tenant
        under its floor is protected entirely; one over its floor
        exposes only the excess as spill victims — so an eviction can
        never dig a tenant below its reservation, and everything it
        frees is genuinely usable by the requester (pages below the
        victim's floor would be withheld from the requester anyway).
        None when the pool has no tenant shares (legacy behaviour)."""
        if not self.pool.tenant_shares:
            return None
        protect: Set[object] = set()
        for t, share in self.pool.tenant_shares.items():
            if t == tenant or share.floor_pages <= 0:
                continue
            kept = 0
            for lease in self.pool.leases.values():
                if lease.owner != "prefetch" or lease.tenant != t:
                    continue
                if kept >= share.floor_pages:
                    break
                protect.add(lease.tag)
                kept += lease.num_pages
        return protect or None

    def commit(self, ticket: AdmissionTicket) -> int:
        """Return the ticket's unconsumed headroom (pages) after dispatch."""
        if ticket.reservation is None:
            return 0
        return self.pool.cancel(ticket.reservation)

    def holds_pending_release(self) -> bool:
        """True iff some current holder will free pages through a future
        event: a pinned prefetch lease (another wave in flight), any
        non-prefetch (e.g. KV) lease, or an outstanding reservation."""
        if self.pool.reservations:
            return True
        return any(l.refcount > 1 or l.owner != "prefetch"
                   for l in self.pool.leases.values())

    # -- parking (waves waiting on page-free events) ------------------------
    def park(self, key: object, npages: int,
             tenant: str = "shared") -> None:
        """Record a stalled wave (``key``) waiting for ``npages`` to
        become free; ``tenant`` keeps the resume stats attributable.
        ``key`` is opaque to the controller: the runtime parks a
        dynamically-formed wave object (whose members re-enter the
        ready set individually on resume) or a ``(cohort, round)``
        tuple in never-re-form mode."""
        self.parked.append((key, int(npages), tenant))

    def unpark_all(self) -> List[Tuple[object, int]]:
        """Hand every parked wave back to the caller for a retry (the
        retry re-enters ``admit``, so order and fairness live there)."""
        out, self.parked = self.parked, []
        self.stats.resumed += len(out)
        for _key, npages, tenant in out:
            self._tstats(tenant).resumed += 1
            self._record("admission.resume", "parked", npages, 0, tenant)
        return [(key, npages) for key, npages, _tenant in out]
