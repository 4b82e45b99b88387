"""Unified serving front-end: the paper's Fig. 7 system as ONE surface.

The public API used to be three disjoint layers callers had to
hand-wire — ``TeleRAGEngine`` (resources), ``RetrievalRuntime`` (one
replica's event loop), and ``MultiReplicaOrchestrator.run_global_batch``
(a *blocking* global batch that drained replicas serially in lockstep).
``TeleRAGServer`` replaces that with a client-facing facade and a
**continuous dispatcher on a shared global event clock**:

  * clients ``submit()`` typed ``RagRequest``s carrying an open-loop
    ``arrival_t`` (plus priority / SLO deadline);
  * at each arrival *wave* the prefetching scheduler groups the wave
    into micro-batches and the cache-aware scheduler routes them to
    replicas (the existing ``SchedulerPolicy``, reading live per-replica
    cache residency and ledger occupancy at the wave's clock time);
  * micro-batches queue per replica and execute on per-replica
    ``RetrievalRuntime``s that the dispatcher *merge-steps* — it always
    advances the runtime holding the globally-earliest event — so
    replica timelines interleave on one clock instead of draining one
    replica at a time.  Open-loop throughput and latency-under-load
    (queue wait + service) are measurable for the first time.

Within a replica the server runs one of two dispatch disciplines.  The
default (``continuous=False``) keeps one micro-batch in flight at a
time; queued batches dispatch the instant the runtime drains, and
``end_batch`` consolidation runs between batches exactly as the legacy
executor did — which is what pins the legacy-equivalence guarantee: for
simultaneous arrivals the server reproduces ``run_global_batch``'s doc
ids and round telemetry to 1e-6 (tests/test_api.py).

``continuous=True`` is **per-request continuous batching inside the
replica**: routed micro-batches are submitted into the live runtime
immediately, the runtime's dynamic wave former
(``SchedulerPolicy.reform_wave``) re-batches whichever requests are
ready at every round frontier — so a straggler never delays its former
batch-mates, new arrivals join in-flight work mid-stream, and the
dispatcher consumes per-request *completion events* instead of batch
drains.  See the "request lifecycle" section of docs/ARCHITECTURE.md.

``ServerTelemetry`` unifies what previously lived in four places —
``buffer.stats``, ``cache.hit_rate``, ``ledger.snapshot()``,
``admission.stats``, and the transfer-engine event list — into one
snapshot the serve drivers and smoke benches print, plus per-tenant
SLO attainment (see docs/TELEMETRY.md for the field reference).

Tenancy and SLOs are first-class: ``RagRequest.tenant`` makes waves
tenant-pure and admission tenant-scoped (per-tenant pool floors/caps
via ``EngineConfig.tenant_shares``), the default ``EdfDispatch`` orders
queued micro-batches by priority class then earliest deadline, and
responses split a deadline miss into missed-in-queue vs
missed-in-service (docs/ARCHITECTURE.md, "multi-tenant SLO-aware
serving").

This module is a copy of the JAX package's module of the same path,
imports repointed.  The tests its comments name pin the JAX package's
copy; ``tests/test_torch_api.py`` holds this one to it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace as dc_replace
from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple)

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.ivf import IVFIndex, probe
from repro_torch.core.schedulers import (Assignment, DispatchPolicy, EdfDispatch,
                                         SchedulerPolicy)
from repro_torch.memory.admission import AdmissionStats
from repro_torch.obs import render as obs_render
from repro_torch.obs.clock import EventClock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import CounterSample, FlightRecorder, RequestEvent
from repro_torch.serving.engine import (EngineConfig, RoundTelemetry,
                                        TeleRAGEngine)
from repro_torch.serving.runtime import (RequestRecord, RequestState,
                                         RetrievalRuntime, Span, percentile_line)
from repro_torch.serving.trace import RequestTrace, make_trace


# ---------------------------------------------------------------------------
# Typed request / response lifecycle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RagRequest:
    """One client request.

    ``pipeline`` names one of the six §5.1 pipelines (the server
    synthesizes a seeded trace); an explicit ``trace`` wins when given.
    ``arrival_t`` is seconds after the drain epoch starts (open-loop
    offered load).  ``tenant`` names who the request belongs to: waves
    are grouped tenant-pure, pool admission reserves against the
    tenant's floor/cap (``EngineConfig.tenant_shares``), and SLO
    attainment is reported per tenant.  The default ``"shared"`` is the
    untenanted sentinel used across the whole stack (no per-tenant
    ledger bytes are tracked for it).  ``priority`` is the dispatch
    priority *class* (lower dispatches first); ``deadline_s`` is an
    arrival→complete SLO bound in seconds — the default ``EdfDispatch``
    orders queued batches earliest-deadline-first within a priority
    class, and the response reports ``deadline_missed`` (split into
    missed-in-queue vs missed-in-service).
    """

    q: np.ndarray
    pipeline: Optional[str] = None
    trace: Optional[RequestTrace] = None
    arrival_t: float = 0.0
    priority: int = 0
    deadline_s: Optional[float] = None
    tenant: str = "shared"

    def __post_init__(self):
        if self.trace is None and self.pipeline is None:
            raise ValueError("RagRequest needs a pipeline name or a trace")


@dataclass(frozen=True)
class RagResponse:
    """One completed request: results + its event-clock life story.

    All timestamps are seconds on the shared global event clock.  The
    deadline flags split an SLO miss by *where* the time was lost:
    ``deadline_missed_in_queue`` means the deadline had already passed
    while the request was still waiting for a replica slot (before
    ``admit_t``) — so no amount of faster service could have saved it —
    while ``deadline_missed`` alone means service itself ran long.
    """

    request_id: int
    pipeline: str
    state: RequestState
    replica: int
    doc_ids: List[np.ndarray]
    rounds: List[RoundTelemetry]
    timeline: List[Span]
    arrival_t: float                 # absolute, on the shared event clock
    admit_t: float                   # dispatch onto the replica runtime
    complete_t: float
    deadline_missed: bool = False
    deadline_missed_in_queue: bool = False
    tenant: str = "shared"
    priority: int = 0
    deadline_s: Optional[float] = None
    demoted_rounds: int = 0          # rounds whose prefetch was demoted

    @property
    def queue_s(self) -> float:
        """Time spent waiting for a replica slot (arrival → admit, s)."""
        return self.admit_t - self.arrival_t

    @property
    def service_s(self) -> float:
        """Admit → complete on the replica's event clock (seconds)."""
        return self.complete_t - self.admit_t

    @property
    def latency_s(self) -> float:
        """End-to-end arrival → complete in seconds (what open-loop
        load inflates)."""
        return self.complete_t - self.arrival_t

    @property
    def stall_s(self) -> float:
        """Seconds parked ``PRESSURE_STALLED`` on pool admission (the
        part of service lost to memory pressure, summed over rounds)."""
        return sum(s.end - s.start for s in self.timeline
                   if s.kind == "pressure_stall")

    def breakdown(self) -> Dict[str, float]:
        """Seconds per lifecycle stage: queue wait plus the summed span
        durations (generate / transfer_wait / retrieve / pressure_stall
        / generate_tail)."""
        out: Dict[str, float] = {"queue": self.queue_s}
        for s in self.timeline:
            if s.end > s.start:
                out[s.kind] = out.get(s.kind, 0.0) + (s.end - s.start)
        return out


def summarize_latency(responses: Sequence[RagResponse]) -> str:
    """One-line nearest-rank p50/p95/mean of arrival→complete latencies
    (the open-loop analogue of ``runtime.latency_summary``)."""
    if not responses:
        return "arrival->complete: no completed requests"
    queue = float(np.mean([r.queue_s for r in responses]))
    return (f"arrival->complete "
            f"{percentile_line([r.latency_s for r in responses])} "
            f"queue_mean={queue*1e3:.1f}ms")


# ---------------------------------------------------------------------------
# Telemetry snapshot
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReplicaTelemetry:
    """One replica's device-side counters at snapshot time."""

    replica: int
    bytes_h2d: int
    pages_h2d: int
    transfer_rounds: int
    cache_hit_rate: float
    ledger: Dict[str, int]
    occupancy: float
    admission: AdmissionStats
    transfers: int
    transfer_queued_s: float
    # chunk-KV effectiveness (empty dict when splicing is not enabled):
    # hit_rate, spliced_pages, prefill_tokens_avoided, prefetched_pages,
    # resident_pages, pinned_pages — see docs/TELEMETRY.md
    chunk_kv: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def capture(cls, i: int, eng: TeleRAGEngine) -> "ReplicaTelemetry":
        """Snapshot replica ``i``'s engine counters (admission stats are
        copied, so the snapshot does not alias live state)."""
        chunk = getattr(eng, "chunk_kv", None)
        return cls(
            replica=i,
            bytes_h2d=eng.buffer.stats.bytes_h2d,
            pages_h2d=eng.buffer.stats.pages_h2d,
            transfer_rounds=eng.buffer.stats.rounds,
            cache_hit_rate=eng.cache.hit_rate,
            ledger=eng.ledger.snapshot(),
            occupancy=eng.ledger.occupancy(),
            admission=dc_replace(eng.admission.stats),
            transfers=len(eng.transfer.events),
            transfer_queued_s=sum(e.queued_s for e in eng.transfer.events),
            chunk_kv=({} if chunk is None else dict(
                chunk.stats.as_dict(),
                resident_pages=chunk.resident_pages(),
                pinned_pages=chunk.pinned_pages())))


@dataclass(frozen=True)
class TenantTelemetry:
    """One tenant's SLO attainment, accumulated over every completed
    response.  Latency percentiles are arrival→complete seconds on the
    event clock; ``stall_s`` is the summed ``PRESSURE_STALLED`` time
    attributable to pool admission; the miss counters match the
    per-response ``deadline_missed`` / ``deadline_missed_in_queue``
    flags exactly (pinned in tests/test_slo.py).  ``kv_bytes`` is the
    tenant's *live* decode-cache footprint summed across replica pools
    (tenant-tagged KV leases) at snapshot time."""

    tenant: str
    completed: int
    p50_latency_s: float
    p99_latency_s: float
    mean_queue_s: float
    stall_s: float
    with_deadline: int               # responses that carried an SLO bound
    deadline_missed: int
    missed_in_queue: int             # deadline passed before admit_t
    demoted_rounds: int              # prefetches demoted as already-missed
    kv_bytes: int = 0                # live KV-lease bytes across replicas
    chunk_kv_bytes: int = 0          # resident chunk-KV bytes attributed to
                                     # this tenant's loads across replicas

    @property
    def missed_in_service(self) -> int:
        """Misses where the request was admitted in time but service ran
        past the deadline (``deadline_missed - missed_in_queue``)."""
        return self.deadline_missed - self.missed_in_queue

    @property
    def attainment(self) -> float:
        """Fraction of deadline-carrying responses that met their SLO
        (1.0 when the tenant never set a deadline)."""
        if not self.with_deadline:
            return 1.0
        return 1.0 - self.deadline_missed / self.with_deadline

    def line(self) -> str:
        """One printable summary line for this tenant (the shared
        ``repro_torch.obs.render`` formatter — same precision as replica
        rows)."""
        return obs_render.render_tenant_line(self)


@dataclass(frozen=True)
class ServerTelemetry:
    """One unified snapshot of the whole serving surface (previously
    scattered across buffer.stats, cache.hit_rate, ledger.snapshot(),
    admission.stats, and transfer events), plus per-tenant SLO
    attainment.  See docs/TELEMETRY.md for the field reference."""

    completed: int
    waves: int
    dispatched_batches: int
    clock_s: float
    replicas: Tuple[ReplicaTelemetry, ...]
    tenants: Tuple[TenantTelemetry, ...] = ()

    @property
    def bytes_h2d(self) -> int:
        """Lifetime H2D bytes summed across replicas."""
        return sum(r.bytes_h2d for r in self.replicas)

    @property
    def pages_h2d(self) -> int:
        """Lifetime H2D pages summed across replicas."""
        return sum(r.pages_h2d for r in self.replicas)

    @property
    def admission_stalled(self) -> int:
        """admit() refusals that parked a wave, summed across replicas."""
        return sum(r.admission.stalled for r in self.replicas)

    @property
    def admission_admitted(self) -> int:
        """Full-headroom admission tickets, summed across replicas."""
        return sum(r.admission.admitted for r in self.replicas)

    @property
    def spilled_pages(self) -> int:
        """Pages reclaimed by admission spill, summed across replicas."""
        return sum(r.admission.spilled_pages for r in self.replicas)

    @property
    def deadline_missed(self) -> int:
        """Deadline misses summed across tenants (== the number of
        completed responses whose ``deadline_missed`` flag is set)."""
        return sum(t.deadline_missed for t in self.tenants)

    def tenant(self, name: str) -> Optional["TenantTelemetry"]:
        """The named tenant's slice, or None if it never completed a
        request."""
        for t in self.tenants:
            if t.tenant == name:
                return t
        return None

    def summary(self) -> str:
        """Multi-line printable snapshot: fleet totals, one line per
        replica, one line per tenant — all through the shared
        ``repro_torch.obs.render`` formatters (one precision everywhere)."""
        return obs_render.render_telemetry(self)


@dataclass(frozen=True)
class WaveDispatch:
    """Routing record of one arrival wave (what run_global_batch's
    report used to expose for the whole batch)."""

    t: float
    assignments: List[Tuple[int, int, int]]   # (batch_idx, replica, overlap)
    requeued: List[int]
    sched_overhead_s: float


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class _Submitted:
    seq: int
    request: RagRequest
    trace: RequestTrace
    arrival_abs: float = 0.0
    replica: int = -1
    record: Optional[RequestRecord] = None


@dataclass(eq=False)
class _QueuedBatch:
    avail_t: float                   # earliest dispatch time (wave clock)
    priority: int
    order: int
    members: List[_Submitted]
    deadline_t: float = float("inf")  # earliest member deadline (absolute)
    tenant: str = "shared"


class _TenantAcc:
    """Per-tenant SLO accumulator backed by the server's metrics
    registry: every field is a first-class instrument (counter or
    histogram) keyed by tenant, and ``snapshot()`` is a *view* over
    them — numerically identical to the pre-registry list/float
    accumulator (``Histogram.percentile`` is ``np.percentile`` over
    the raw latency samples; pinned by tests/test_obs.py)."""

    def __init__(self, metrics: MetricsRegistry, tenant: str):
        self.tenant = tenant
        self._lat = metrics.histogram("request_latency_s", tenant=tenant)
        self._queue_s = metrics.counter("request_queue_s", tenant=tenant)
        self._stall_s = metrics.counter("request_stall_s", tenant=tenant)
        self._completed = metrics.counter("requests_completed",
                                          tenant=tenant)
        self._with_deadline = metrics.counter("requests_with_deadline",
                                              tenant=tenant)
        self._missed = metrics.counter("deadline_missed", tenant=tenant)
        self._missed_in_queue = metrics.counter("deadline_missed_in_queue",
                                                tenant=tenant)
        self._demoted = metrics.counter("demoted_rounds", tenant=tenant)

    @property
    def completed(self) -> int:
        return int(self._completed.value)

    def note(self, r: "RagResponse") -> None:
        self._lat.observe(r.latency_s)
        self._queue_s.inc(r.queue_s)
        self._stall_s.inc(r.stall_s)
        self._completed.inc()
        self._demoted.inc(r.demoted_rounds)
        if r.deadline_s is not None:
            self._with_deadline.inc()
            self._missed.inc(int(r.deadline_missed))
            self._missed_in_queue.inc(int(r.deadline_missed_in_queue))

    def snapshot(self, tenant: str, kv_bytes: int = 0,
                 chunk_kv_bytes: int = 0) -> TenantTelemetry:
        return TenantTelemetry(
            tenant=tenant, completed=self.completed,
            p50_latency_s=self._lat.percentile(50),
            p99_latency_s=self._lat.percentile(99),
            mean_queue_s=self._queue_s.value / max(1, self.completed),
            stall_s=self._stall_s.value,
            with_deadline=int(self._with_deadline.value),
            deadline_missed=int(self._missed.value),
            missed_in_queue=int(self._missed_in_queue.value),
            demoted_rounds=int(self._demoted.value),
            kv_bytes=int(kv_bytes), chunk_kv_bytes=int(chunk_kv_bytes))


class TeleRAGServer:
    """Client-facing facade over N replica engines + a continuous
    cross-replica dispatcher on one shared event clock."""

    def __init__(self, index: IVFIndex, cfg: EngineConfig,
                 num_replicas: int = 1,
                 arch: Optional[ArchConfig] = None, *,
                 scheduler: Optional[SchedulerPolicy] = None,
                 micro_batch: Optional[int] = None,
                 include_tail: bool = False,
                 batch_window_s: float = 0.0,
                 decode_hook: Optional[Callable] = None,
                 dispatch: Optional[DispatchPolicy] = None,
                 continuous: bool = False,
                 trace: Optional[FlightRecorder] = None,
                 wall_clock=None):
        """``scheduler=None`` forms FIFO micro-batches and routes them
        round-robin (persistent across waves); a ``SchedulerPolicy``
        enables the paper's similarity grouping + cache-aware routing.
        ``micro_batch=None`` keeps each wave whole.  ``batch_window_s``
        gathers open-loop arrivals within the window into one wave
        (0 = every distinct arrival instant is its own wave).
        ``decode_hook(replica, records, gen_tokens, round)`` runs real
        decode inside each round frontier, after the async prefetch
        dispatch — prefetch is dispatched exactly once, by the policy;
        it may return per-request ``DecodeEvent``s whose observed
        timing drives the event clock in place of the modeled window.
        ``dispatch`` orders each replica's queued micro-batches; the
        default ``EdfDispatch`` runs priority classes then earliest
        deadline first, which degrades to the legacy (priority, FIFO)
        order when no request sets a deadline.

        ``continuous=True`` enables per-request continuous batching
        inside each replica: routed micro-batches are submitted into
        the replica runtime *immediately* (no one-batch-at-a-time
        serialization), the runtime's dynamic wave former re-batches
        whichever requests are ready at every round frontier
        (``SchedulerPolicy.reform_wave``, ``micro_batch``-capped,
        tenant-pure), and the dispatcher consumes **per-request
        completion events** instead of waiting for batch drains.
        ``continuous=False`` (the default) keeps the legacy
        group-granular execution that the deprecated shims are pinned
        against: one micro-batch in flight per replica, ``end_batch``
        consolidation between batches.

        ``wall_clock`` is the injected real-time source for the few
        measurements that are genuinely about THIS machine (scheduler
        overhead, host-search calibration).  The default is the
        deterministic ``obs.clock.EventClock`` — identical inputs give
        identical traces; launch drivers that want real measurement
        pass ``obs.clock.SystemClock()``."""
        self.index = index
        self.cfg = cfg
        self.continuous = bool(continuous)
        # ONE flight recorder across the whole server: every replica's
        # runtime, pool, admission controller, transfer engine and KV
        # manager emits into the same stream, correlated by replica id
        # (pass ``trace=`` to cap capacity or share a recorder)
        self.recorder = trace if trace is not None else FlightRecorder()
        self.wall = wall_clock if wall_clock is not None \
            else EventClock(self.recorder)
        self.metrics = MetricsRegistry()
        self.engines = [TeleRAGEngine(index, cfg, arch,
                                      wall_clock=self.wall)
                        for _ in range(num_replicas)]
        for i, eng in enumerate(self.engines):
            eng.attach_recorder(self.recorder, i)
        # under continuous dispatch the runtime's wave former IS the
        # scheduler policy (its reform_wave hook); the static path keeps
        # runtimes scheduler-free because the server already grouped
        self.runtimes = [
            RetrievalRuntime(
                eng, include_tail=include_tail,
                reform=self.continuous,
                scheduler=(scheduler if self.continuous else None),
                micro_batch=(micro_batch if self.continuous else None),
                on_complete=((lambda rec, _r=r:
                              self._on_request_complete(_r, rec))
                             if self.continuous else None),
                on_generate=(None if decode_hook is None else
                             (lambda recs, toks, rnd, _r=r:
                              decode_hook(_r, recs, toks, rnd))))
            for r, eng in enumerate(self.engines)]
        self.scheduler = scheduler
        self.dispatch = dispatch if dispatch is not None else EdfDispatch()
        self.micro_batch = micro_batch
        self.batch_window_s = float(batch_window_s)
        self.dead: Set[int] = set()
        self.nprobe_for_sched = min(64, index.num_clusters)
        self.wave_log: List[WaveDispatch] = []
        self.last_records: List[RequestRecord] = []
        self.last_responses: List[RagResponse] = []
        self._seq = itertools.count()
        self._order = itertools.count()
        self._inbox: List[_Submitted] = []
        self._queues: List[List[_QueuedBatch]] = [
            [] for _ in range(num_replicas)]
        self._busy = [False] * num_replicas
        self._rr = 0                       # round-robin cursor (no scheduler)
        self._global_now = 0.0
        # lifetime counts live in the registry; telemetry() reads them
        self._c_completed = self.metrics.counter("server_completed")
        self._c_waves = self.metrics.counter("server_waves")
        self._c_batches = self.metrics.counter("server_batches")
        self._tenant_acc: Dict[str, _TenantAcc] = {}

    # ---- replica health ----------------------------------------------------
    def mark_dead(self, replica: int) -> None:
        """Exclude a replica from routing; its queued batches re-route
        on the next wave (recorded in ``WaveDispatch.requeued``)."""
        self.dead.add(int(replica))

    def mark_alive(self, replica: int) -> None:
        """Return a previously ``mark_dead``ed replica to routing."""
        self.dead.discard(int(replica))

    # ---- submission --------------------------------------------------------
    def submit(self, request: RagRequest) -> int:
        """Queue one request for the next drain; returns its request id."""
        seq = next(self._seq)
        trace = request.trace
        if trace is None:
            trace = make_trace(request.pipeline, seq,
                               np.random.default_rng(self.cfg.seed + seq))
        self._inbox.append(_Submitted(seq=seq, request=request, trace=trace))
        return trace.request_id

    def serve(self, requests: Sequence[RagRequest]) -> List[RagResponse]:
        """submit() them all, then drain()."""
        for r in requests:
            self.submit(r)
        return self.drain()

    # ---- the continuous dispatcher ----------------------------------------
    def drain(self) -> List[RagResponse]:
        """Run the dispatcher until every submitted request completes;
        responses come back in submission order.

        The loop merges two event sources on the shared clock: arrival
        waves (grouped + routed when their time comes) and the replica
        runtimes' own event heaps (always stepping the globally-earliest
        one, so replica timelines interleave)."""
        if not self._inbox:
            return []
        subs, self._inbox = self._inbox, []
        try:
            epoch = max([self._global_now]
                        + [rt.now for rt in self.runtimes])
            for s in subs:
                s.arrival_abs = epoch + max(0.0, float(s.request.arrival_t))
                # server-side arrival mark: the analyzer's queue-time
                # attribution reads submit -> (replica) admit
                self.recorder.emit(RequestEvent(
                    t=s.arrival_abs, kind="request", replica=-1,
                    request_id=s.trace.request_id,
                    tenant=s.request.tenant, label="submit"))
            waves = self._form_waves(subs)
            wi = 0
            while (wi < len(waves)
                   or any(rt.has_work() for rt in self.runtimes)):
                nxt: Optional[Tuple[float, int]] = None
                for r, rt in enumerate(self.runtimes):
                    t = rt.next_event_t()
                    if t is not None and (nxt is None or t < nxt[0]):
                        nxt = (t, r)
                if wi < len(waves) and (nxt is None
                                        or waves[wi][0] <= nxt[0]):
                    wave_t, members = waves[wi]
                    wi += 1
                    self._route_wave(wave_t, members)
                else:
                    t, r = nxt
                    rt = self.runtimes[r]
                    rt.step()
                    if not rt.has_work():
                        self._complete_batch(r)
        except BaseException:
            # a failed drain must not swallow work the caller handed us:
            # requests never dispatched to a replica go back to the inbox
            # so a retry after recovery (e.g. mark_alive) serves them;
            # ones already on a failed runtime cannot be replayed safely
            self._inbox = [s for s in subs if s.record is None] + self._inbox
            raise
        self._global_now = max([self._global_now]
                               + [rt.now for rt in self.runtimes])
        ordered = sorted(subs, key=lambda s: s.seq)
        responses = [self._response(s) for s in ordered]
        self.last_records = [s.record for s in ordered]
        self.last_responses = responses
        return responses

    def telemetry(self) -> ServerTelemetry:
        """One unified snapshot across every replica's counters, plus
        per-tenant SLO attainment accumulated over completed responses."""
        return ServerTelemetry(
            completed=int(self._c_completed.value),
            waves=int(self._c_waves.value),
            dispatched_batches=int(self._c_batches.value),
            clock_s=self._global_now,
            replicas=tuple(ReplicaTelemetry.capture(i, e)
                           for i, e in enumerate(self.engines)),
            tenants=tuple(
                acc.snapshot(t, kv_bytes=sum(
                    e.pool.tenant_bytes(t, owner="kv")
                    for e in self.engines),
                    chunk_kv_bytes=sum(
                        e.pool.tenant_bytes(t, owner="chunk_kv")
                        for e in self.engines))
                for t, acc in sorted(self._tenant_acc.items())))

    # ---- internals ---------------------------------------------------------
    def _form_waves(self, subs: List[_Submitted],
                    ) -> List[Tuple[float, List[_Submitted]]]:
        """Partition arrivals into waves.  A wave opens at its first
        arrival and closes ``batch_window_s`` later; it fires at its
        last member's arrival (== the first's when the window is 0)."""
        subs = sorted(subs, key=lambda s: (s.arrival_abs, s.seq))
        waves: List[Tuple[float, List[_Submitted]]] = []
        cur: List[_Submitted] = []
        t0 = 0.0
        for s in subs:
            if cur and s.arrival_abs - t0 > self.batch_window_s + 1e-12:
                waves.append((cur[-1].arrival_abs, cur))
                cur = []
            if not cur:
                t0 = s.arrival_abs
            cur.append(s)
        if cur:
            waves.append((cur[-1].arrival_abs, cur))
        return waves

    def _route_wave(self, wave_t: float, members: List[_Submitted]) -> None:
        """Group the wave into micro-batches and route them to replica
        queues — reading each replica's *live* cache residency, ledger
        occupancy, and per-tenant pool occupancy at the wave's clock
        time.  Micro-batches are tenant-pure: similarity grouping runs
        within each tenant's slice of the wave, so admission
        reservations and ledger attribution are well-defined per batch
        (a single-tenant wave reduces to the legacy grouping exactly)."""
        t0 = self.wall.perf()
        q = np.stack([np.asarray(s.request.q) for s in members])
        mb = self.micro_batch or len(members)
        by_tenant: Dict[str, List[int]] = {}
        for i, s in enumerate(members):
            by_tenant.setdefault(s.request.tenant, []).append(i)
        groups: List[List[int]] = []
        for idxs in by_tenant.values():
            if self.scheduler is not None:
                sub = self.scheduler.group(q[idxs], mb)
            else:
                sub = [list(range(i, min(i + mb, len(idxs))))
                       for i in range(0, len(idxs), mb)]
            groups.extend([idxs[j] for j in grp] for grp in sub)
        if self.scheduler is not None:
            if self.scheduler.needs_cluster_hints:
                batch_clusters = []
                for g in groups:
                    ranked = probe(q[g], self.index, self.nprobe_for_sched)
                    batch_clusters.append(
                        set(int(c) for r in ranked for c in r))
            else:
                batch_clusters = [set() for _ in groups]
            caches = [e.buffer.resident_clusters() for e in self.engines]
            occupancy = [e.ledger.occupancy() for e in self.engines]
            # the untenanted sentinel gets no spread penalty: legacy
            # single-tenant routing must see exactly the PR-3 scores
            tenant_occupancy = [
                [0.0 for _ in self.engines]
                if members[g[0]].request.tenant == "shared" else
                [e.pool.tenant_pages(members[g[0]].request.tenant)
                 / max(1, e.pool.num_pages) for e in self.engines]
                for g in groups]
            assigns = self.scheduler.assign(batch_clusters, caches,
                                            occupancy=occupancy,
                                            tenant_occupancy=tenant_occupancy)
        else:
            assigns = []
            for i in range(len(groups)):
                assigns.append(Assignment(
                    replica=self._rr % len(self.engines),
                    batch_index=i, overlap=0))
                self._rr += 1
        alive = [i for i in range(len(self.engines)) if i not in self.dead]
        if not alive:
            raise RuntimeError("no healthy replicas")
        requeued: List[int] = []
        fixed: List[Assignment] = []
        for a in assigns:
            if a.replica in self.dead:
                requeued.append(a.batch_index)
                a = Assignment(replica=alive[a.batch_index % len(alive)],
                               batch_index=a.batch_index, overlap=0)
            fixed.append(a)
        self.wave_log.append(WaveDispatch(
            t=wave_t,
            assignments=[(a.batch_index, a.replica, a.overlap)
                         for a in fixed],
            requeued=requeued,
            sched_overhead_s=self.wall.perf() - t0))
        self._c_waves.inc()
        # occupancy time series on the event clock: one sample per
        # replica at every routed wave (what a control loop consumes)
        for i, e in enumerate(self.engines):
            self.metrics.series("ledger_occupancy", replica=i).sample(
                wave_t, e.ledger.occupancy())
        touched = []
        for a in fixed:
            batch = [members[i] for i in groups[a.batch_index]]
            for s in batch:
                s.replica = a.replica
            self._queues[a.replica].append(_QueuedBatch(
                avail_t=wave_t,
                priority=min(s.request.priority for s in batch),
                deadline_t=min(self._deadline_abs(s) for s in batch),
                tenant=batch[0].request.tenant,
                order=next(self._order), members=batch))
            touched.append(a.replica)
        for r in dict.fromkeys(touched):
            self.recorder.emit(CounterSample(
                t=wave_t, kind="counter", replica=r,
                name="queue_depth", value=float(len(self._queues[r]))))
            self._maybe_dispatch(r)

    @staticmethod
    def _deadline_abs(s: _Submitted) -> float:
        """A submission's absolute event-clock deadline in seconds
        (``inf`` when the request carries no SLO bound)."""
        if s.request.deadline_s is None:
            return float("inf")
        return s.arrival_abs + float(s.request.deadline_s)

    def _maybe_dispatch(self, r: int) -> None:
        """Feed the replica's best queued micro-batch to its runtime the
        moment it is idle — at the later of the wave's clock time and
        the runtime's own clock.  "Best" is the ``DispatchPolicy``'s
        call: the default EDF order runs priority classes first and the
        earliest absolute deadline within a class (pure head-of-line
        FIFO when nothing carries a deadline).  Under ``continuous``
        dispatch there is no idle gate: every queued micro-batch is
        submitted into the (possibly mid-flight) runtime immediately —
        its requests join waves at the next round frontier."""
        if not self.continuous and self._busy[r]:
            return
        qr = self._queues[r]
        rt = self.runtimes[r]
        submitted = False
        while qr:
            pick = min(range(len(qr)),
                       key=lambda i: self.dispatch.key(
                           priority=qr[i].priority,
                           deadline_t=qr[i].deadline_t,
                           order=qr[i].order, now=rt.now))
            batch = qr.pop(pick)
            t_disp = max(batch.avail_t, rt.now)
            for s in batch.members:
                s.record = rt.submit(s.request.q, s.trace, arrival_t=t_disp,
                                     tenant=s.request.tenant,
                                     priority=s.request.priority,
                                     deadline_t=self._deadline_abs(s))
            submitted = True
            self._c_batches.inc()
            if not self.continuous:
                rt.begin(rebase=False)
                self._busy[r] = True
                return
        if submitted:
            # one begin() for everything this call queued: begin scans
            # ALL pending submissions, so per-batch calls would push
            # duplicate admit events (O(k^2) heap traffic per wave)
            rt.begin(rebase=False)

    def _on_request_complete(self, r: int, rec: RequestRecord) -> None:
        """Per-request completion event from a continuous replica
        runtime — the dispatcher's unit of progress under per-request
        batching (the legacy path instead counts whole batch drains in
        ``_complete_batch``)."""
        self._c_completed.inc()

    def _complete_batch(self, r: int) -> None:
        """A replica drained its in-flight work: consolidate the engine
        (end_batch, as the legacy per-group executor did) and dispatch
        the next queued batch at the replica's clock.  Under continuous
        dispatch completions were already counted per request, so this
        only consolidates."""
        recs = self.runtimes[r].collect()
        if not self.continuous:
            self._c_completed.inc(len(recs))
        self._busy[r] = False
        self._maybe_dispatch(r)

    def _response(self, s: _Submitted) -> RagResponse:
        """Fold one finished submission into a RagResponse, stamping
        the deadline verdict (split into missed-in-queue — the deadline
        had already passed before the request ever reached a replica —
        vs missed-in-service) and accumulating the tenant's SLO stats."""
        rec = s.record
        deadline_abs = self._deadline_abs(s)
        missed = rec.complete_t > deadline_abs + 1e-12
        missed_in_queue = rec.admit_t > deadline_abs + 1e-12
        resp = RagResponse(
            request_id=rec.request_id, pipeline=rec.pipeline,
            state=rec.state, replica=s.replica,
            doc_ids=list(rec.result.doc_ids),
            rounds=list(rec.result.rounds),
            timeline=list(rec.timeline),
            arrival_t=s.arrival_abs, admit_t=rec.admit_t,
            complete_t=rec.complete_t, deadline_missed=missed,
            deadline_missed_in_queue=missed_in_queue,
            tenant=s.request.tenant, priority=s.request.priority,
            deadline_s=s.request.deadline_s,
            demoted_rounds=rec.demoted_rounds)
        tenant = s.request.tenant
        if tenant not in self._tenant_acc:
            self._tenant_acc[tenant] = _TenantAcc(self.metrics, tenant)
        self._tenant_acc[tenant].note(resp)
        if s.request.deadline_s is not None:
            # attainment time series: 1/0 per deadline-carrying response
            # at its completion time (mean over a window = attainment)
            self.metrics.series("attainment", tenant=tenant).sample(
                rec.complete_t, 0.0 if missed else 1.0)
        return resp
