"""The flight recorder: one structured event bus for the serving stack.

Every subsystem emits typed ``TraceEvent``s — request lifecycle marks,
timeline spans, wave form/dispatch/complete, transfer issue/land,
admission decisions, pool lease/release, decode steps, counter samples
— stamped on the **shared event clock** (modeled seconds, the same
clock ``RetrievalRuntime`` and ``TeleRAGServer`` advance).  One
``FlightRecorder`` serves a whole ``TeleRAGServer``: every replica
engine's components are attached to it with their replica id, so
cross-replica correlation (which wave, which tenant, which request)
is a filter over one stream instead of a join across ad-hoc logs.

Clock discipline: components deep in the stack (the pool, the
admission controller) do not receive ``now`` — they stamp events at
``recorder.now``, which the runtime advances via ``tick()`` at every
event-loop step.  Events may therefore be *appended* slightly out of
``t`` order (a wave's completion is emitted at schedule time with its
future timestamp); consumers that need time order use
``sorted_events()``.

``legacy_tuples()`` is the compatibility shim for the retired
``RetrievalRuntime.event_log`` list: the same ``(t, label,
request_id)`` 3-tuples, in emission order, filtered to one replica's
lane — existing tests and benches keep iterating it unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the request-lifecycle labels the retired ``runtime.event_log`` carried;
# ``legacy_tuples()`` reproduces exactly these (a server-side "submit"
# mark is NOT one of them — it never appeared in the legacy log)
LEGACY_LABELS = frozenset({
    "admit", "prefetch", "generate", "retrieve", "complete",
    "pressure_stall", "pressure_resume", "prefetch_demoted",
})


@dataclass(frozen=True)
class TraceEvent:
    """Base event: a kind, a stamp on the shared event clock (seconds),
    and the correlation ids every consumer filters by.  ``replica=-1``
    means "not attached to a replica" (a standalone engine, or the
    server itself); ``request_id``/``wave_id`` are -1 when the event is
    not about one request/wave."""

    t: float
    kind: str
    replica: int = -1
    request_id: int = -1
    wave_id: int = -1
    tenant: str = "shared"


@dataclass(frozen=True)
class RequestEvent(TraceEvent):
    """One request-lifecycle mark (``kind="request"``): ``label`` is
    the lifecycle step (``submit`` / ``admit`` / ``prefetch`` /
    ``generate`` / ``retrieve`` / ``complete`` / ``pressure_stall`` /
    ``pressure_resume`` / ``prefetch_demoted``)."""

    label: str = ""
    round_index: int = -1


@dataclass(frozen=True)
class SpanEvent(TraceEvent):
    """One request-timeline interval (``kind="span"``): mirrors the
    ``Span`` appended to ``RequestRecord.timeline`` (``name`` is the
    span kind, ``t`` its start, ``dur`` its length — 0 for instants)."""

    name: str = ""
    dur: float = 0.0
    round_index: int = -1


@dataclass(frozen=True)
class WaveEvent(TraceEvent):
    """One wave-lifecycle mark: ``wave.form`` when the executor takes
    the wave up, ``wave.dispatch`` when it actually executes (a parked
    wave forms but never dispatches — it dissolves and its members ride
    a later wave), ``wave.complete`` at its last member's scheduled
    round end.  ``transfer_id`` correlates the dispatch with the wave's
    lookahead copy (-1 = no prefetch moved)."""

    size: int = 0
    request_ids: Tuple[int, ...] = ()
    rounds: Tuple[int, ...] = ()
    transfer_id: int = -1
    nbytes: int = 0


@dataclass(frozen=True)
class TransferRecord(TraceEvent):
    """One H2D copy on the modeled link: ``transfer.issue`` at submit,
    ``transfer.land`` at its modeled completion (emitted at schedule
    time with the future stamp).  Mirrors ``TransferEvent``."""

    transfer_id: int = -1
    nbytes: int = 0
    n_clusters: int = 0
    channel: int = -1
    start_t: float = 0.0
    end_t: float = 0.0
    transfer_kind: str = "prefetch"


@dataclass(frozen=True)
class AdmissionEvent(TraceEvent):
    """One admission decision: ``admission.admit`` (full headroom),
    ``admission.stall`` (parked ``PRESSURE_STALLED``),
    ``admission.cap`` (granted below the request),
    ``admission.spill`` (the spill hook reclaimed pages), or
    ``admission.resume`` (a parked wave woken by a page-free)."""

    owner: str = ""
    pages_requested: int = 0
    pages_granted: int = 0
    spilled_pages: int = 0


@dataclass(frozen=True)
class PoolEvent(TraceEvent):
    """One page-pool allocation edge: ``pool.lease`` / ``pool.release``
    with the post-op free-page count and ledger occupancy — the
    exporters' counter tracks (pool free pages, ledger occupancy,
    per-tenant KV bytes) are derived from this stream."""

    owner: str = ""                   # ledger category: prefetch | kv | ...
    pages: int = 0
    nbytes: int = 0
    free_pages: int = 0
    occupancy: float = 0.0


@dataclass(frozen=True)
class KVEvent(TraceEvent):
    """One decode-cache lease edge (``kv.acquire`` / ``kv.append`` /
    ``kv.splice`` / ``kv.release`` / ``kv.drop``): the KV manager's view
    on top of the pool's byte accounting.  Dense bucket leases emit
    acquire/release with ``lease_id=-1`` (``recycled=True`` when the
    acquire reused a released bucket instead of allocating, and
    ``kv.drop`` when a recycled bucket's bytes finally return to the
    pool — together these keep the checker's kv accounting
    conservation-exact across bucket recycling); paged (block-table)
    leases additionally carry a globally unique ``lease_id``, their slab
    page count (``pages``) and — on every ``kv.append`` — the
    post-append max sequence ``length``, which is what the invariant
    checker conserves (page conservation per lease,
    append-within-lease ordering, no append past ``max_len``).
    ``kv.splice`` marks precomputed chunk-KV pages attached to an open
    paged lease by block-table edit: ``pages`` spliced page slots,
    ``length`` the post-splice max length, ``max_len`` the lease's
    raised capacity."""

    batch: int = 0
    max_len: int = 0
    nbytes: int = 0
    lease_id: int = -1                # paged leases only; -1 = dense bucket
    pages: int = 0                    # slab page slots held by the lease
    length: int = 0                   # kv.append: max lengths after the write
    recycled: bool = False            # dense acquire reused a released bucket


@dataclass(frozen=True)
class ChunkKVEvent(TraceEvent):
    """One chunk-KV residency edge (``chunk.load`` / ``chunk.pin`` /
    ``chunk.unpin`` / ``chunk.evict``): the lifecycle of one document's
    precomputed KV pages on device.  ``chunk.load`` lands ``pages``
    slab pages H2D (charged to the pool as owner ``"chunk_kv"``);
    ``chunk.pin``/``chunk.unpin`` bracket a wave's splice (``pinned``
    is the post-op pin count — pinned residency is protected from
    spill); ``chunk.evict`` returns the pages (legal only at
    ``pinned == 0``).  The invariant checker conserves pages per
    (replica, doc) and rejects pin-before-load (the splice-before-land
    race) and evict-while-pinned."""

    doc_id: int = -1
    pages: int = 0
    nbytes: int = 0
    pinned: int = 0                   # pin count after this event


@dataclass(frozen=True)
class DecodeStep(TraceEvent):
    """One observed decode outcome (``kind="decode"``): the hook ran
    ``tokens`` real steps in ``seconds`` measured wall clock for a wave
    of ``batch`` (mirrors ``DecodeEvent``, which drives the clock)."""

    tokens: int = 0
    seconds: float = 0.0
    batch: int = 0


@dataclass(frozen=True)
class CounterSample(TraceEvent):
    """One sampled scalar (``kind="counter"``) for exporter counter
    tracks the pool stream cannot derive (e.g. per-replica queue
    depth)."""

    name: str = ""
    value: float = 0.0


@dataclass
class FlightRecorder:
    """Append-only typed event log on the shared event clock.

    ``now`` is the recorder's clock cursor, advanced monotonically by
    ``tick()`` from whichever runtime is stepping — it is what
    emitters without a ``now`` of their own (pool, admission) stamp
    with.  ``capacity`` bounds memory for long-lived servers: when
    exceeded, the oldest half of the log is dropped (a flight recorder
    keeps the recent past; ``dropped`` counts the loss so analyzers
    can report a truncated window instead of silently lying)."""

    capacity: Optional[int] = None
    now: float = 0.0
    events: List[TraceEvent] = field(default_factory=list)
    dropped: int = 0

    def tick(self, t: float) -> float:
        """Advance the clock cursor (monotone); returns the cursor."""
        if t > self.now:
            self.now = t
        return self.now

    def emit(self, ev: TraceEvent) -> TraceEvent:
        """Append one event (also advances ``now`` to the event's stamp
        when it is ahead — emitters schedule future completions)."""
        self.events.append(ev)
        if self.capacity is not None and len(self.events) > self.capacity:
            drop = len(self.events) // 2
            del self.events[:drop]
            self.dropped += drop
        return ev

    # -- queries -------------------------------------------------------------
    def of(self, *kinds: str) -> List[TraceEvent]:
        """Events whose kind is one of ``kinds`` (emission order)."""
        want = set(kinds)
        return [e for e in self.events if e.kind in want]

    def for_request(self, request_id: int) -> List[TraceEvent]:
        """Every event correlated to one request (emission order)."""
        return [e for e in self.events if e.request_id == request_id]

    def sorted_events(self) -> List[TraceEvent]:
        """All events in event-clock order (stable for equal stamps)."""
        return sorted(self.events, key=lambda e: e.t)

    def request_marks(self, request_id: int) -> Dict[str, float]:
        """label -> first event-clock time, over one request's
        lifecycle marks (the admit<=dispatch<=complete ordering check
        reads this)."""
        out: Dict[str, float] = {}
        for e in self.events:
            if (e.kind == "request" and e.request_id == request_id
                    and e.label not in out):
                out[e.label] = e.t
        return out

    def legacy_tuples(self, replica: Optional[int] = None,
                      ) -> List[Tuple[float, str, int]]:
        """The retired ``runtime.event_log`` view: ``(t, label,
        request_id)`` tuples in emission order, filtered to one
        replica's lane (None = all lanes) and to the labels the legacy
        log carried."""
        return [(e.t, e.label, e.request_id) for e in self.events
                if e.kind == "request" and e.label in LEGACY_LABELS
                and (replica is None or e.replica == replica)]

    def clear(self) -> None:
        """Drop all events (the clock cursor is kept — it is shared
        with live runtimes and must stay monotone)."""
        self.events.clear()
        self.dropped = 0
