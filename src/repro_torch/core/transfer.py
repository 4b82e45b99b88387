"""Async H2D transfer engine: timestamped in-flight copy events (§4.1).

The paper's central mechanism is that lookahead prefetch *overlaps* the
CPU→GPU cluster copy with the LLM's pre-retrieval generation window.  The
legacy model expressed that overlap as a post-hoc ``max(t_llm,
t_prefetch)``; here each copy is a first-class ``TransferEvent`` with a
``[start_t, end_t)`` occupancy window on a double-buffered link, so
overlap (and queueing, when transfers contend) emerges from event
ordering in the ``RetrievalRuntime`` event loop instead of a closed-form
composition.

``PrefetchBuffer`` is the backing store: ``submit()`` dispatches the real
asynchronous copy through the buffer immediately (``non_blocking``
copies from pinned host pages on a side CUDA stream) — dispatch returns before
the copy completes, which is what lets subsequent decode steps overlap
it — and returns the modeled occupancy window for the event clock.  On
a CUDA device each ``TransferEvent`` also carries the ``torch.cuda.Event``
recorded after its copy (``cuda_event``), which consumers wait on.

Link model: ``channels`` independent DMA channels (2 = double buffering,
matching the paper's pinned staging buffers).  A transfer starts on the
earliest-free channel at ``max(submit_t, channel_free_at)`` and holds it
for ``nbytes / link_bw`` seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core.prefetch_buffer import PrefetchBuffer
from repro_torch.memory.pool import Reservation
from repro_torch.obs.recorder import FlightRecorder, TransferRecord


@dataclass(frozen=True)
class TransferEvent:
    """One in-flight (or completed) H2D copy on the modeled clock."""

    transfer_id: int
    clusters: Tuple[int, ...]
    nbytes: int
    channel: int
    submit_t: float
    start_t: float
    end_t: float
    kind: str = "prefetch"            # "prefetch" | "demand"
    # torch.cuda.Event recorded after the real copy (None on a CPU device
    # or when no page moved)
    cuda_event: Any = field(default=None, compare=False, repr=False)

    @property
    def duration(self) -> float:
        return self.end_t - self.start_t

    @property
    def queued_s(self) -> float:
        """Time the copy waited for a free channel."""
        return self.start_t - self.submit_t

    def done_by(self, t: float) -> bool:
        return self.end_t <= t

    def overlaps(self, lo: float, hi: float) -> bool:
        """True iff the copy's link occupancy intersects window [lo, hi)."""
        return self.start_t < hi and lo < self.end_t


class TransferEngine:
    """Owns the modeled host→device link and dispatches real buffer loads."""

    def __init__(self, buffer: PrefetchBuffer, link_bw: float, *,
                 channels: int = 2):
        assert channels >= 1
        self.buffer = buffer
        self.link_bw = float(link_bw)
        self.channel_free = [0.0] * channels
        self.events: List[TransferEvent] = []
        self._next_id = 0
        # flight-recorder lane (attached by the owning engine/server)
        self.recorder: Optional[FlightRecorder] = None
        self.replica_id = -1

    # -- submission ---------------------------------------------------------
    def submit(self, clusters: Sequence[int], *, now: float = 0.0,
               nbytes: Optional[int] = None, link_bw: Optional[float] = None,
               kind: str = "prefetch",
               make_room: Optional[Callable[[int], object]] = None,
               reservation: Optional[Reservation] = None,
               ) -> TransferEvent:
        """Dispatch an async copy of whole clusters; return its event.

        The device scatter is issued immediately through the backing
        ``PrefetchBuffer`` (async dispatch).  ``reservation`` is the
        admission headroom this copy consumes its page slots from.
        ``make_room``, when given, is called with a page count if the
        buffer rejects clusters for lack of free slots, then the rejects
        are re-issued — mirroring the legacy engine's eviction-retry
        path.  ``nbytes`` overrides the byte count used for the
        occupancy window (defaults to the pages actually moved);
        ``link_bw`` overrides the link for this copy (used by the
        runtime-fetch baseline's modeled demand fetch).
        """
        clusters = [int(c) for c in clusters]
        self.buffer.last_event = None
        loaded, rejected = self.buffer.load_clusters(clusters,
                                                     reservation=reservation)
        if rejected and make_room is not None:
            make_room(sum(int(self.buffer.paged.cluster_num_pages[c])
                          for c in rejected))
            _, rejected = self.buffer.load_clusters(rejected,
                                                    reservation=reservation)
        if rejected:
            # never leak planned clusters silently: shrink the copy (and
            # its modeled byte count — the link must not be occupied for
            # pages that never moved) to what actually landed
            dropped = set(rejected)
            clusters = [c for c in clusters if c not in dropped]
            if nbytes is not None:
                nbytes = max(0, nbytes - sum(
                    self.buffer.paged.cluster_bytes(c) for c in dropped))
        if nbytes is None:
            nbytes = sum(self.buffer.paged.cluster_bytes(c) for c in clusters)
        bw = self.link_bw if link_bw is None else float(link_bw)
        dur = nbytes / bw if nbytes else 0.0
        ch = min(range(len(self.channel_free)),
                 key=lambda i: self.channel_free[i])
        start = max(float(now), self.channel_free[ch])
        ev = TransferEvent(transfer_id=self._next_id,
                           clusters=tuple(clusters), nbytes=int(nbytes),
                           channel=ch, submit_t=float(now), start_t=start,
                           end_t=start + dur, kind=kind,
                           cuda_event=self.buffer.last_event)
        self._next_id += 1
        self.channel_free[ch] = ev.end_t
        self.events.append(ev)
        if self.recorder is not None:
            # issue at submit, land at the modeled completion (emitted
            # now, stamped with its future clock time)
            for when, k in ((ev.submit_t, "transfer.issue"),
                            (ev.end_t, "transfer.land")):
                self.recorder.emit(TransferRecord(
                    t=when, kind=k, replica=self.replica_id,
                    transfer_id=ev.transfer_id, nbytes=ev.nbytes,
                    n_clusters=len(ev.clusters), channel=ev.channel,
                    start_t=ev.start_t, end_t=ev.end_t,
                    transfer_kind=ev.kind))
        return ev

    # -- queries ------------------------------------------------------------
    def in_flight(self, t: float) -> List[TransferEvent]:
        return [e for e in self.events if e.start_t <= t < e.end_t]

    def drained_at(self) -> float:
        """Clock time at which every submitted copy has completed."""
        return max(self.channel_free)

    def ready_t(self, event: TransferEvent, dispatch_t: float) -> float:
        """When ``event``'s data is usable by a consumer that dispatched
        its own view of the copy at ``dispatch_t``.

        Per-request link view (App. C): a micro-batch shares one physical
        copy, but each request models the transfer window from its own
        round boundary — ``dispatch_t + duration`` — because its lookahead
        dispatch is what it overlaps against.  Real queueing delay
        (``event.end_t``) still lower-bounds readiness so contended links
        are never under-modeled.
        """
        return max(event.end_t, dispatch_t + event.duration)

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.events)
