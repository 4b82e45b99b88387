"""Event-driven retrieval runtime: per-request continuous batching over
a priority event queue (§4.1/§4.2 made operational).

Replaces the lockstep ``execute_batch`` loop.  Requests are **admitted**
at arrival time and walked through a per-request state machine

    QUEUED -> ADMITTED -> PREFETCHING -> GENERATING -> RETRIEVING
           ->  (ready: next round | COMPLETE)
                  |  ^
                  v  | page-free event
           PRESSURE_STALLED

driven by a min-heap of timestamped events on a modeled wall clock.

Execution is **wave-formed**: there is no static batch.  Whenever one
or more requests become *ready* (admitted, resumed from a pressure
park, or finishing a retrieval round), a **round frontier** fires and
the dynamic wave former re-batches whichever requests are ready *right
now* — same replica, tenant-pure, honoring the ``micro_batch`` cap —
into fresh micro-batches (``_Wave``s).  A slow request therefore never
drags its former batch-mates: they re-form into new waves the moment
their own rounds end, newly admitted requests join mid-stream, and a
request parked ``PRESSURE_STALLED`` rejoins whatever wave forms at its
wake-up.  Wave membership (and therefore the decode batch size each
generation window is modeled at) reflects who is *actually* decoding
together.  ``SchedulerPolicy.reform_wave`` owns the ordering (default:
EDF within priority classes, FIFO among equals).

Per-request bookkeeping is keyed by the request, not the wave: buffer
pins (a request's working set stays pinned until *its* completion
event), admission parking, and round telemetry (``RoundTelemetry``
carries ``wave_id`` / ``round_start_t`` / ``round_end_t``) all hang off
``RequestRecord``.  Admission reservations are aggregated per wave (one
ticket covers the wave's batched lookahead plan) but park and resume
per request.

Decode can be **real and asynchronous**: the ``on_generate`` hook runs
actual device decode inside the round frontier (the prefetch copy
dispatched just before it is genuinely in flight underneath) and may
return per-request ``DecodeEvent``s — observed decode steps whose
measured seconds then *drive the event clock* in place of the trace's
static ``llm_window_seconds`` estimate.

A round frontier first *reserves* the wave's lookahead page headroom
with the engine's ``AdmissionController``; when the shared
``DevicePagePool`` cannot promise the pages, the wave's members park
``PRESSURE_STALLED`` and resume on the page-free event of a completing
request's pin release — the planner never silently truncates its plan.
Prefetch copies are ``TransferEvent``s on the engine's double-buffered
link, so overlap between a transfer and a generation window is a fact
of the event timeline (two intersecting intervals), not a ``max()``.

**Never-re-form mode** (``reform=False``): the degenerate setting runs
the same wave executor on *static cohorts* — the request's admission
group is its wave for every round, frontiers fire at the cohort's
earliest finisher, and each member keeps its own round start — which
reproduces the legacy group-granular executor bit-for-bit (doc ids
exact, telemetry to 1e-6; pinned by tests/test_runtime.py and
tests/test_api.py).  ``PipelineExecutor`` and ``run_global_batch`` run
in this mode.

A request's admit→complete latency is read off the event clock
(``RequestRecord.latency``), which is what the serve drivers report.

This module is a copy of the JAX package's module of the same path,
imports repointed.  The tests its comments name pin the JAX package's
copy; ``tests/test_torch_api.py`` holds this one to it.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.embedder import synthetic_rewrite
from repro_torch.core.schedulers import SchedulerPolicy
from repro_torch.memory.pool import PoolExhausted
from repro_torch.obs.recorder import (DecodeStep, FlightRecorder, RequestEvent,
                                      SpanEvent, WaveEvent)
from repro_torch.serving.engine import (RequestResult, RoundTelemetry,
                                        TeleRAGEngine)
from repro_torch.serving.policies import LatencyContext
from repro_torch.serving.trace import RequestTrace


class RequestState(str, Enum):
    QUEUED = "queued"
    ADMITTED = "admitted"                   # ready: waiting for a wave
    PRESSURE_STALLED = "pressure_stalled"   # parked: pool reservation failed
    PREFETCHING = "prefetching"
    GENERATING = "generating"
    RETRIEVING = "retrieving"
    COMPLETE = "complete"


@dataclass(frozen=True)
class Span:
    """One interval on a request's timeline ([t, t] for instant events)."""

    kind: str
    start: float
    end: float
    round_index: int = -1

    def intersects(self, lo: float, hi: float) -> bool:
        """True iff this span intersects the open interval (lo, hi):
        strict inequalities on both sides, so touching endpoints (and a
        zero-length span AT an endpoint) do not count as overlap, while
        a zero-length span strictly inside (lo, hi) does."""
        return self.start < hi and lo < self.end

    def overlaps(self, lo: float, hi: float) -> bool:
        """Back-compat alias for :meth:`intersects`."""
        return self.intersects(lo, hi)


@dataclass(frozen=True)
class DecodeEvent:
    """One request's *observed* decode outcome for a generation window.

    The ``on_generate`` hook returns one per wave member when it runs
    real decode: ``tokens`` steps were actually executed in ``seconds``
    of measured wall clock.  The runtime then models the member's full
    generation window from the observed per-step rate instead of the
    trace's static hardware estimate — real decode drives the event
    clock."""

    request_id: int
    tokens: int                   # decode steps actually executed
    seconds: float                # measured wall-clock for those steps

    def window(self, gen_tokens: int) -> float:
        """Seconds for a ``gen_tokens``-step window at the observed
        per-step rate (``seconds`` verbatim when no steps ran)."""
        if self.tokens <= 0:
            return float(self.seconds)
        return float(self.seconds) * (gen_tokens / self.tokens)


@dataclass(eq=False)                   # identity semantics: records are
class RequestRecord:                   # live state, and `q` is an ndarray
    """One request's live serving state on a replica runtime: identity,
    event-clock timestamps (seconds), state-machine position, and the
    span timeline the telemetry layer reads.

    The record IS the unit of execution: ``plan`` (its retrieval round
    shapes), ``cur_q`` (its drifting query), ``next_round`` and
    ``ready_t`` (when its next round may start) make it independently
    schedulable, and buffer pins / admission parking are keyed by the
    record itself.  ``deadline_t`` is the request's *absolute* deadline
    on the shared event clock (``inf`` = no SLO); ``tenant`` /
    ``priority`` carry the SLO identity the wave former and admission
    control act on."""

    request_id: int
    pipeline: str
    trace: RequestTrace
    q: np.ndarray
    arrival_t: float
    result: RequestResult
    admit_t: float = float("nan")
    complete_t: float = float("nan")
    state: RequestState = RequestState.QUEUED
    timeline: List[Span] = field(default_factory=list)
    round_start: List[float] = field(default_factory=list)
    tenant: str = "shared"
    priority: int = 0
    deadline_t: float = float("inf")
    demoted_rounds: int = 0            # rounds whose prefetch was demoted
    # per-request round machine (populated at admit)
    plan: List[Tuple[int, int]] = field(default_factory=list)
    cur_q: Optional[np.ndarray] = None
    next_round: int = 0
    ready_t: float = float("nan")

    @property
    def latency(self) -> float:
        """Admit→complete on the event clock (seconds)."""
        return self.complete_t - self.admit_t

    def spans(self, kind: str) -> List[Span]:
        """All timeline spans of one kind (e.g. ``"pressure_stall"``)."""
        return [s for s in self.timeline if s.kind == kind]


def percentile_line(latencies: Sequence[float]) -> str:
    """Nearest-rank p50/p95/mean/max of a latency sample, in ms."""
    lats = np.sort(np.asarray(latencies))
    nearest = lambda q: lats[max(0, -(-len(lats) * q // 100) - 1)]
    return (f"p50={nearest(50)*1e3:.1f}ms p95={nearest(95)*1e3:.1f}ms "
            f"mean={lats.mean()*1e3:.1f}ms max={lats[-1]*1e3:.1f}ms")


def latency_summary(records: Sequence["RequestRecord"]) -> str:
    """One-line nearest-rank p50/p95/mean of admit→complete latencies."""
    if not records:
        return "admit->complete: no completed requests"
    return f"admit->complete {percentile_line([r.latency for r in records])}"


def round_plan(trace: RequestTrace) -> List[Tuple[int, int]]:
    """[(gen_tokens_before_retrieval, num_queries), ...] per round."""
    plan: List[Tuple[int, int]] = []
    acc = 0
    for s in trace.stages:
        if s.kind == "retrieve":
            plan.append((acc, s.num_queries))
            acc = 0
        else:
            acc += s.gen_tokens
    return plan


def tail_gen_tokens(trace: RequestTrace) -> int:
    """Generation after the last retrieval (counts once per request;
    for a decode-only trace this is the whole trace)."""
    acc = 0
    for s in trace.stages:
        acc = 0 if s.kind == "retrieve" else acc + s.gen_tokens
    return acc


@dataclass(eq=False)
class _Cohort:
    """Never-re-form mode's static admission group: its members stay
    wave-mates for every round (the legacy ``_Group`` semantics)."""

    gid: int
    members: List[RequestRecord]
    scheduled_rounds: set = field(default_factory=set)


@dataclass(eq=False)
class _Wave:
    """One dynamically-formed micro-batch: the requests executing a
    round frontier together (mixed ``rounds`` indices are normal — a
    mid-stream admit's round 0 batches with a veteran's round 2)."""

    wid: int
    t: float                              # frontier clock time
    members: List[RequestRecord]
    rounds: List[int]                     # per-member round index
    tenant: str = "shared"
    # parked by KV-slab pressure (decode hook's acquire_paged failed):
    # on resume EVERY member re-enters the ready set — including
    # tail-only members, whose decode also never ran (an admission park
    # runs tails as their own wave before parking, so those stay
    # excluded from the wake)
    kv_parked: bool = False

    @property
    def request_ids(self) -> Tuple[int, ...]:
        """Member request ids (telemetry / test introspection)."""
        return tuple(m.request_id for m in self.members)


# forced frontiers fall back to this former: it places EVERY ready
# request, so a custom policy that keeps deferring cannot stall a drain
_BASE_FORMER = SchedulerPolicy()


class RetrievalRuntime:
    """Per-request continuous-batching executor for one engine replica."""

    def __init__(self, engine: TeleRAGEngine, *,
                 scheduler: Optional[SchedulerPolicy] = None,
                 micro_batch: Optional[int] = None,
                 ctx: Optional[LatencyContext] = None,
                 include_tail: bool = False,
                 on_generate: Optional[Callable[[List["RequestRecord"],
                                                 List[int], int],
                                                Optional[Sequence[
                                                    DecodeEvent]]]] = None,
                 reform: bool = True,
                 on_complete: Optional[Callable[["RequestRecord"],
                                                None]] = None):
        """``reform=True`` (the default) runs the dynamic wave former:
        every round frontier re-batches the currently-ready requests.
        ``reform=False`` is the degenerate never-re-form mode — the
        admission group is the wave for every round — which reproduces
        the legacy group-granular executor exactly (the deprecated
        shims run in this mode).  ``on_generate`` is the decode hook:
        called once per wave frontier, right after the async prefetch
        dispatch, with the wave's records and their generation-window
        token counts; serve drivers run REAL decode here (the copy is
        genuinely in flight underneath) and may return per-request
        ``DecodeEvent``s whose observed timing replaces the modeled
        generation window on the event clock.  ``on_complete`` fires at
        each request's completion event (the server's continuous
        dispatcher consumes these instead of waiting for batch
        drains)."""
        self.engine = engine
        self.scheduler = scheduler
        self.micro_batch = micro_batch
        self._ctx = ctx
        self.include_tail = include_tail
        self.on_generate = on_generate
        self.on_complete = on_complete
        self.reform = reform
        # the wave former: the scheduler policy when given (its
        # reform_wave hook), else the base EDF/tenant-aware default
        self._former = scheduler if scheduler is not None \
            else SchedulerPolicy()
        self._rng = np.random.default_rng(engine.cfg.seed + 1)
        self._now = 0.0                      # drained clock across run()s
        self._seq = itertools.count()
        self._gid = itertools.count()
        self._wid = itertools.count()
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._pending: List[RequestRecord] = []
        self._batch: List[RequestRecord] = []
        self._ready: List[RequestRecord] = []
        self._retry_scheduled = False
        self.wave_log: List[_Wave] = []
        # page-free events wake PRESSURE_STALLED requests
        engine.pool.subscribe(self._on_pages_freed)

    # ---- flight recorder ---------------------------------------------------
    @property
    def recorder(self) -> FlightRecorder:
        """The replica's trace stream (engine-owned; the server rebinds
        every replica onto one shared recorder)."""
        return self.engine.recorder

    @property
    def replica_id(self) -> int:
        """This runtime's lane in the shared recorder (the engine's
        replica id; -1 for a standalone engine)."""
        return self.engine.replica_id

    @property
    def event_log(self) -> List[Tuple[float, str, int]]:
        """Legacy view of the request-lifecycle stream: ``(t, label,
        request_id)`` tuples in emission order, exactly what the old
        ad-hoc list recorded.  The typed events are the source of
        truth; this is a compatibility shim."""
        return self.recorder.legacy_tuples(self.replica_id)

    def _emit_req(self, t: float, label: str, rec: RequestRecord, *,
                  round_index: int = -1, wave_id: int = -1) -> None:
        """One request-lifecycle event into the flight recorder."""
        self.recorder.emit(RequestEvent(
            t=t, kind="request", replica=self.replica_id,
            request_id=rec.request_id, tenant=rec.tenant,
            wave_id=wave_id, label=label, round_index=round_index))

    def _span(self, req: RequestRecord, kind: str, start: float,
              end: float, rnd: int = -1, *, wave_id: int = -1) -> None:
        """Append to the request's timeline AND trace the same interval
        as a typed ``SpanEvent`` (the exporters' track content)."""
        req.timeline.append(Span(kind, start, end, rnd))
        self.recorder.emit(SpanEvent(
            t=start, kind="span", replica=self.replica_id,
            request_id=req.request_id, tenant=req.tenant, wave_id=wave_id,
            name=kind, dur=end - start, round_index=rnd))

    @property
    def ctx(self) -> LatencyContext:
        """The timing-plane constants (lazily built from the engine)."""
        if self._ctx is None:
            self._ctx = LatencyContext.from_engine(self.engine)
        return self._ctx

    # ---- submission --------------------------------------------------------
    def submit(self, q: np.ndarray, trace: RequestTrace,
               arrival_t: float = 0.0, *, tenant: str = "shared",
               priority: int = 0,
               deadline_t: float = float("inf")) -> RequestRecord:
        """Queue one request. ``arrival_t`` is relative to this run's
        start (the clock is monotonic across run() calls);
        ``deadline_t`` is the request's absolute event-clock deadline in
        seconds (``inf`` = no SLO) and ``tenant``/``priority`` tag it
        for tenant-scoped admission and SLO accounting."""
        rec = RequestRecord(
            request_id=trace.request_id, pipeline=trace.pipeline,
            trace=trace, q=np.asarray(q), arrival_t=float(arrival_t),
            result=RequestResult(trace.request_id, trace.pipeline),
            tenant=tenant, priority=int(priority),
            deadline_t=float(deadline_t))
        self._pending.append(rec)
        self._batch.append(rec)
        return rec

    # ---- event loop --------------------------------------------------------
    def _push(self, t: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    @property
    def now(self) -> float:
        """Current position on the (monotonic) event clock."""
        return self._now

    def begin(self, *, rebase: bool = True) -> None:
        """Seed admit events for everything submitted since the last
        wave.  ``rebase=True`` (the legacy ``run()`` path) offsets the
        pending arrival times by the current clock; ``rebase=False``
        treats them as *absolute* event-clock times — the
        ``TeleRAGServer`` dispatches on one shared global clock and has
        already placed the wave on it (clamped monotone as a guard)."""
        if rebase:
            base = self._now
            for rec in self._pending:
                rec.arrival_t += base
        else:
            for rec in self._pending:
                rec.arrival_t = max(rec.arrival_t, self._now)
        for t in sorted({r.arrival_t for r in self._pending}):
            self._push(t, "admit", ())

    def has_work(self) -> bool:
        """True while events remain, requests are ready for a wave, or
        requests are parked on pressure."""
        return (bool(self._heap) or bool(self._ready)
                or bool(self.engine.admission.parked))

    def next_event_t(self) -> Optional[float]:
        """Clock time of the next event this runtime would process (the
        server's merge key across replicas); None when drained."""
        if self._heap:
            return self._heap[0][0]
        if self._ready or self.engine.admission.parked:
            return self._now
        return None

    def step(self) -> float:
        """Process exactly one event; returns the clock after it.  The
        ``TeleRAGServer`` interleaves replicas by always stepping the
        runtime with the globally-earliest ``next_event_t``."""
        if not self._heap:
            if self._ready:
                # a custom former deferred requests and nothing else is
                # coming: force a frontier so the drain terminates
                self._on_frontier(True, now=self._now)
                return self._now
            # every waker has fired and requests are still parked (the
            # pressure came from holders outside the event loop, e.g.
            # recycled KV buckets): force a capped admission so the
            # drain terminates — the shortfall lands on admission
            # stats, never on silently dropped work
            self._retry_parked(self._now, force=True)
            return self._now
        t, _, kind, payload = heapq.heappop(self._heap)
        self._now = max(self._now, t)
        # deep components (pool, admission, KV) stamp at recorder.now —
        # the event loop owns the clock, so it advances it
        self.recorder.tick(self._now)
        if kind == "admit":
            self._on_admit(t)
        elif kind == "round":
            self._on_round(*payload, now=t)
        elif kind == "frontier":
            self._on_frontier(*payload, now=t)
        elif kind == "ready":
            self._on_ready(*payload, now=t)
        elif kind == "retry":
            self._retry_scheduled = False
            self._retry_parked(t)
        elif kind == "mark":
            rec, state, label = payload
            if state is not None:
                rec.state = state
            self._emit_req(t, label, rec)
            if state is RequestState.COMPLETE:
                self._on_member_complete(rec, t)
        return self._now

    def collect(self) -> List[RequestRecord]:
        """Post-drain consolidation: end_batch the engine and hand back
        the records submitted since the last collect (submission order)."""
        self.engine.end_batch()
        out, self._batch = self._batch, []
        return out

    def run(self) -> List[RequestRecord]:
        """Drain all submitted requests; return their records (submission
        order).  Consolidates the engine (end_batch) once drained."""
        self.begin()
        while self.has_work():
            self.step()
        return self.collect()

    # ---- admission of arrivals ---------------------------------------------
    def _admit_record(self, m: RequestRecord, now: float) -> None:
        """Common per-request admission bookkeeping (both modes)."""
        m.admit_t = now
        m.state = RequestState.ADMITTED
        m.plan = round_plan(m.trace)
        m.cur_q = np.array(m.q, copy=True)
        m.next_round = 0
        m.ready_t = now
        m.round_start = [now] + [float("nan")] * max(0, len(m.plan) - 1)
        self._span(m, "admit", now, now)
        self._emit_req(now, "admit", m)

    def _on_admit(self, now: float) -> None:
        ready = [r for r in self._pending if r.arrival_t <= now + 1e-12]
        if not ready:
            return
        self._pending = [r for r in self._pending if r not in ready]
        if self.reform:
            # per-request admission: every arrival is individually ready
            # and joins whatever wave the next frontier forms (mid-stream
            # admission into an in-flight replica is the normal path —
            # decode-only requests included)
            for m in ready:
                self._admit_record(m, now)
            self._ready.extend(ready)
            self._push(now, "frontier", (False,))
            return
        # never-re-form mode: the admission group IS the wave for every
        # round (legacy semantics, pinned equivalent)
        q = np.stack([r.q for r in ready])
        if self.scheduler is None:
            groups_idx = [list(range(len(ready)))]
        else:
            groups_idx = self.scheduler.group(
                q, self.micro_batch or len(ready))
        for gi in groups_idx:
            members = [ready[i] for i in gi]
            for m in members:
                self._admit_record(m, now)
            # decode-only traces ride the normal per-request path as
            # tail-only singleton waves (no special-case completion)
            with_rounds = [m for m in members if m.plan]
            for m in members:
                if not m.plan:
                    self._exec_wave(
                        _Wave(wid=next(self._wid), t=now, members=[m],
                              rounds=[0], tenant=m.tenant),
                        now=now, starts=[now])
            if with_rounds:
                g = _Cohort(gid=next(self._gid), members=with_rounds)
                g.scheduled_rounds.add(0)
                self._push(now, "round", (g, 0))

    # ---- frontiers ---------------------------------------------------------
    def _on_round(self, g: _Cohort, rnd: int, force: bool = False, *,
                  now: float) -> None:
        """Never-re-form frontier: the cohort's active members execute
        round ``rnd`` as one wave, each from its own round start."""
        members = [m for m in g.members if rnd < len(m.plan)]
        if not members:
            return
        wave = _Wave(wid=next(self._wid), t=now, members=members,
                     rounds=[rnd] * len(members), tenant=members[0].tenant)
        self._exec_wave(wave, now=now,
                        starts=[m.round_start[rnd] for m in members],
                        force=force, cohort=g)

    def _on_frontier(self, force: bool = False, *, now: float) -> None:
        """Dynamic round frontier: re-batch whichever requests are ready
        *now* into fresh waves (the former orders/partitions; members a
        custom former defers stay ready for the next frontier).  A
        *forced* frontier (the event queue would otherwise drain) uses
        the base former, which places every ready request — a custom
        former that keeps deferring cannot livelock the drain."""
        ready = [r for r in self._ready
                 if r.state == RequestState.ADMITTED]
        self._ready = []
        if not ready:
            return
        former = _BASE_FORMER if force else self._former
        waves_idx = former.reform_wave(ready,
                                       micro_batch=self.micro_batch,
                                       now=now)
        placed = set()
        for wi in waves_idx:
            members = [ready[i] for i in wi]
            placed.update(wi)
            wave = _Wave(wid=next(self._wid), t=now, members=members,
                         rounds=[m.next_round for m in members],
                         tenant=members[0].tenant)
            self._exec_wave(wave, now=now, starts=[now] * len(members),
                            force=force)
        self._ready.extend(r for i, r in enumerate(ready)
                           if i not in placed)

    def _on_ready(self, rec: RequestRecord, *, now: float) -> None:
        """A request's round ended: it is ready for the next frontier."""
        if rec.state in (RequestState.COMPLETE,
                         RequestState.PRESSURE_STALLED):
            return
        rec.state = RequestState.ADMITTED
        rec.ready_t = now
        self._ready.append(rec)
        self._push(now, "frontier", (False,))

    # ---- the wave executor -------------------------------------------------
    @staticmethod
    def _member_cluster_sets(plan, n_members: int, *, wave_level: bool,
                             ) -> Tuple[List[List[int]], List[List[int]]]:
        """Per-member (resident-hit, fetch) cluster lists for pinning.
        ``wave_level=True`` (never-re-form mode) gives every member the
        wave's full sets — the legacy release timing, where a shared
        working set frees only when the LAST group member completes.
        Otherwise each member gets the clusters its own ranked row
        contributed, so its exclusive pages free at its own completion."""
        if wave_level or plan.ranked is None:
            return ([list(plan.resident_hits)] * n_members,
                    [list(plan.fetch)] * n_members)
        hits_all = set(map(int, plan.resident_hits))
        fetch_all = set(map(int, plan.fetch))
        hit_sets, fetch_sets = [], []
        for k in range(n_members):
            row = set(map(int, plan.ranked[k]))
            hit_sets.append(sorted(row & hits_all))
            fetch_sets.append(sorted(row & fetch_all))
        return hit_sets, fetch_sets

    def _exec_wave(self, wave: _Wave, *, now: float,
                   starts: Sequence[float], force: bool = False,
                   cohort: Optional[_Cohort] = None) -> None:
        """Execute one wave's round frontier: reserve the wave's pool
        headroom (or park its members ``PRESSURE_STALLED``), run the
        engine data ops for the whole wave, and schedule each member's
        per-request events from its own round start.  ``starts`` is the
        per-member round start (== ``now`` for dynamically formed
        waves; the member's own round clock in never-re-form mode,
        where a cohort frontier fires at its earliest finisher)."""
        eng = self.engine
        policy = eng.policy
        members, rounds = wave.members, wave.rounds
        batch = len(members)
        self.recorder.emit(WaveEvent(
            t=now, kind="wave.form", replica=self.replica_id,
            wave_id=wave.wid, tenant=wave.tenant, size=batch,
            request_ids=wave.request_ids, rounds=tuple(rounds)))
        # members still retrieving vs. decode-only / tail-only members
        ret = [j for j in range(batch) if rounds[j] < len(members[j].plan)]
        gen_tokens = [
            members[j].plan[rounds[j]][0] if rounds[j] < len(members[j].plan)
            else (tail_gen_tokens(members[j].trace)
                  if self.include_tail else 0)
            for j in range(batch)]

        # 0a) slack-based demotion: a round whose every retrieving member
        #     is already past its deadline cannot make its SLO no matter
        #     how fast retrieval runs — spending pool pages and link
        #     bandwidth on its lookahead only starves requests that CAN
        #     still meet theirs.  The round executes (misses go to host
        #     search) but its prefetch is demoted to nothing.
        demoted = (policy.prefetches and bool(ret)
                   and all(now > members[j].deadline_t + 1e-12
                           for j in ret))
        if demoted:
            for j in ret:
                req = members[j]
                req.demoted_rounds += 1
                self._emit_req(now, "prefetch_demoted", req,
                               round_index=rounds[j], wave_id=wave.wid)

        # 0) admission: the wave's lookahead plan reserves its headroom
        #    up front (ONE reservation aggregated over the wave); if the
        #    pool cannot promise the pages, every member parks and
        #    resumes on a page-free event — the planner never silently
        #    truncates under someone else's pressure.  Pins are keyed
        #    per REQUEST: each member holds the wave's working set until
        #    its own completion event.
        plan = ticket = None
        act_q = None
        hit_pins: List[object] = []
        fetch_pins: List[object] = []
        keys = tuple(members[j] for j in ret)
        if ret:
            act_q = np.stack([members[j].cur_q for j in ret])
        if ret and policy.prefetches and not demoted:
            plan = eng.plan_lookahead(act_q, [gen_tokens[j] for j in ret],
                                      wave_key=keys)
            # per-request working sets: in reform mode each member pins
            # only the clusters ITS OWN ranked row needs, so a finished
            # request's exclusive pages free immediately instead of
            # waiting for the whole wave (never-re-form mode keeps
            # wave-level sets — the legacy group release timing)
            hit_sets, fetch_sets = self._member_cluster_sets(
                plan, len(ret), wave_level=cohort is not None)
            # pin the plan's resident hits BEFORE admission: the spill
            # that makes room for this wave's reservation must not evict
            # the clusters the plan counts on finding on-device
            hit_pins = [eng.buffer.pin_clusters(m, cs)
                        for m, cs in zip(keys, hit_sets)]
            # stalling is only sound if someone ELSE will free pages —
            # the wave's own pins must not make it wait on itself
            waitable = (eng.buffer.pages_pinned_by_others(keys) > 0
                        or bool(eng.pool.reservations)
                        or any(l.owner != "prefetch"
                               for l in eng.pool.leases.values()))
            ticket = eng.admission.admit(plan.pages_planned,
                                         owner=f"w{wave.wid}",
                                         can_wait=waitable and not force,
                                         tenant=wave.tenant,
                                         wave_id=wave.wid)
            if ticket is None:
                # a parked wave holds nothing: keeping tentative hit pins
                # would make other parked waves mutually wait on them —
                # the plan is recomputed from scratch on resume anyway
                for m, pins in zip(keys, hit_pins):
                    eng.buffer.release_pins(m, pins)
                eng.admission.park(
                    (cohort, rounds[0]) if cohort is not None else wave,
                    plan.pages_planned, tenant=wave.tenant)
                for j in ret:
                    req = members[j]
                    req.state = RequestState.PRESSURE_STALLED
                    self._emit_req(now, "pressure_stall", req,
                                   wave_id=wave.wid)
                # decode-only wave-mates need no pool pages: they must
                # not be swallowed by the park — run them as their own
                # wave right now (only dynamic waves mix tail members)
                tails = [j for j in range(batch) if j not in set(ret)]
                if tails:
                    self._exec_wave(
                        _Wave(wid=next(self._wid), t=now,
                              members=[members[j] for j in tails],
                              rounds=[rounds[j] for j in tails],
                              tenant=wave.tenant),
                        now=now, starts=[starts[j] for j in tails])
                return

        # the wave is logged only once it actually executes — a parked
        # wave dissolves and its members are re-logged with the wave
        # they eventually ride
        self.wave_log.append(wave)

        # steps 1-3 run under a release-on-exception guard: a raising
        # decode hook / transfer / retrieval must not strand the wave's
        # cluster pins or its admission reservation — the members never
        # reach their completion events (the normal release point), so
        # without the cleanup the pool shrinks forever (telint TL001;
        # regression: tests/test_analysis.py)
        try:
            # 1) lookahead prefetch keyed on the *current* queries,
            #    dispatched (async) at the frontier — in flight during
            #    generation.  A demoted round moves nothing (it only
            #    flushes queued device invalidations so the search LUT
            #    stays consistent).
            nbytes, nfetch, ev = 0, 0, None
            if ret and policy.prefetches:
                if demoted:
                    eng.buffer.flush_invalidations()
                else:
                    nbytes, nfetch, ev = eng.lookahead_ex(
                        act_q, [gen_tokens[j] for j in ret], now=now,
                        plan=plan, ticket=ticket, tenant=wave.tenant)
            self.recorder.emit(WaveEvent(
                t=now, kind="wave.dispatch", replica=self.replica_id,
                wave_id=wave.wid, tenant=wave.tenant, size=batch,
                request_ids=wave.request_ids, rounds=tuple(rounds),
                transfer_id=ev.transfer_id if ev is not None else -1,
                nbytes=nbytes))
            if plan is not None:
                # each member owns its share of the fetched set too,
                # until its own completion event
                fetch_pins = [eng.buffer.pin_clusters(m, cs)
                              for m, cs in zip(keys, fetch_sets)]

            # 1b) real decode (serve drivers): the copy dispatched above
            #     is in flight while the hook's device steps run;
            #     observed per-request DecodeEvents replace the modeled
            #     windows.  KV pressure inside the hook (acquire_paged
            #     against an exhausted slab/pool) is an admission
            #     decision, not a crash: shed what fits, park the rest
            #     PRESSURE_STALLED to rejoin on page-free.
            decode_evs: Optional[List[DecodeEvent]] = None
            if self.on_generate is not None and (ret or any(gen_tokens)):
                try:
                    evs = self._generate_with_kv_relief(
                        members, gen_tokens, rounds[0], tenant=wave.tenant)
                except PoolExhausted:
                    if cohort is not None:
                        # never-re-form mode: cohorts cannot split or
                        # dissolve, so pressure cannot shed or park
                        raise
                    self._shed_on_kv_pressure(
                        wave, keys, hit_pins, fetch_pins, ticket,
                        now=now, starts=starts)
                    return
                if evs is not None:
                    if len(evs) != batch:
                        raise ValueError(
                            f"decode hook returned {len(evs)} events for "
                            f"a wave of {batch}")
                    # match by request id, not position: a hook returning
                    # events in any order must not cross-wire the windows
                    by_id = {e.request_id: e for e in evs}
                    if len(by_id) != batch or any(m.request_id not in by_id
                                                  for m in members):
                        raise ValueError(
                            "decode events must carry exactly the wave "
                            "members' request ids")
                    decode_evs = [by_id[m.request_id] for m in members]

            # 2) rewrite -> q_out (SubQ expands to num_queries rewrites)
            res = None
            owners: List[int] = []
            q_out = None
            if ret:
                q_out_rows: List[np.ndarray] = []
                for k, j in enumerate(ret):
                    sigma = members[j].trace.rewrite_sigma
                    nq = members[j].plan[rounds[j]][1]
                    for _ in range(nq):
                        q_out_rows.append(
                            synthetic_rewrite(act_q[k][None, :], sigma,
                                              self._rng)[0]
                            if sigma > 0 else act_q[k])
                        owners.append(j)
                q_out = np.stack(q_out_rows)

                # 3) hybrid retrieval (device hits + host misses + merge)
                res = eng.retrieve(q_out, now=now, tenant=wave.tenant)
        except BaseException:
            # drop every pin the wave's members hold (hit pins taken
            # before admission, fetch pins taken above, and any earlier
            # rounds' pins — the requests are dead; their completion
            # events will never fire) and return the reservation's
            # unconsumed headroom (lookahead_ex commits on its own
            # paths; pool.cancel is idempotent so a second commit is
            # a no-op)
            for m in keys:
                eng.buffer.unpin(m)
            if ticket is not None:
                eng.admission.commit(ticket)
            raise

        # 4) per-request telemetry + event-clock scheduling
        t_transfer = nbytes / eng.cfg.hw.host_link_bw
        mean_pages = float(np.mean(eng.index.paged.cluster_num_pages))
        continuing: List[float] = []
        wave_end = now
        for j in range(batch):
            req, rnd, rs = members[j], rounds[j], starts[j]
            win = eng.llm_window_seconds(gen_tokens[j], batch)
            if decode_evs is not None and decode_evs[j].tokens > 0:
                # an event with no observed steps (the hook had nothing
                # to decode for this member) keeps the modeled window
                win = decode_evs[j].window(gen_tokens[j])
            if decode_evs is not None:
                self.recorder.emit(DecodeStep(
                    t=rs, kind="decode", replica=self.replica_id,
                    request_id=req.request_id, tenant=req.tenant,
                    wave_id=wave.wid, tokens=decode_evs[j].tokens,
                    seconds=decode_evs[j].seconds, batch=batch))
            if j not in ret:
                # decode-only / tail-only member: its "round" is one
                # generation window, then completion — the same wave
                # machinery, no special-case branch
                if win > 0:
                    self._span(req, "generate_tail", rs, rs + win,
                               wave_id=wave.wid)
                    self._push(rs, "mark", (req, RequestState.GENERATING,
                                            "generate"))
                req.complete_t = rs + win
                self._span(req, "complete", req.complete_t,
                           req.complete_t)
                self._push(req.complete_t, "mark",
                           (req, RequestState.COMPLETE, "complete"))
                wave_end = max(wave_end, req.complete_t)
                continue
            rows = [r for r, o in enumerate(owners) if o == j]
            hits = sum(len(res.hit_clusters[r]) for r in rows)
            misses = sum(len(res.missed_clusters[r]) for r in rows)
            rt = RoundTelemetry(
                round_index=rnd, batch=batch, gen_tokens=gen_tokens[j],
                t_llm_window=win,
                bytes_prefetched=nbytes // max(len(ret), 1),
                t_prefetch=t_transfer,
                hits=hits, misses=misses,
                t_host_search=misses * eng.effective_tcc(),
                t_dev_search=eng._dev_search_seconds(
                    int(hits * mean_pages)),
                t_merge=2e-5,
                wave_id=wave.wid, round_start_t=rs)
            req.result.rounds.append(rt)
            req.result.doc_ids.extend(res.doc_ids[r] for r in rows)

            gen_end = rs + rt.t_llm_window
            ready = None
            if policy.prefetches and ev is not None:
                ready = eng.transfer.ready_t(ev, rs)
            retrieve_start = (gen_end if ready is None
                              else max(gen_end, ready))
            round_end = retrieve_start + policy.search_seconds(rt, self.ctx)
            rt.round_end_t = round_end

            if policy.prefetches and not demoted:
                self._span(req, "prefetch_dispatch", rs, rs, rnd,
                           wave_id=wave.wid)
                self._push(rs, "mark",
                           (req, RequestState.PREFETCHING, "prefetch"))
            self._span(req, "generate", rs, gen_end, rnd,
                       wave_id=wave.wid)
            self._push(rs, "mark", (req, RequestState.GENERATING, "generate"))
            if retrieve_start > gen_end:
                self._span(req, "transfer_wait", gen_end, retrieve_start,
                           rnd, wave_id=wave.wid)
            self._span(req, "retrieve", retrieve_start, round_end, rnd,
                       wave_id=wave.wid)
            self._push(retrieve_start, "mark",
                       (req, RequestState.RETRIEVING, "retrieve"))
            wave_end = max(wave_end, round_end)

            req.next_round = rnd + 1
            if rnd + 1 < len(req.plan):
                req.round_start[rnd + 1] = round_end
                req.ready_t = round_end
                if cohort is not None:
                    continuing.append(round_end)
                else:
                    self._push(round_end, "ready", (req,))
            else:
                complete_t = round_end
                if self.include_tail:
                    tail_s = eng.llm_window_seconds(
                        tail_gen_tokens(req.trace), batch)
                    if decode_evs is not None and decode_evs[j].tokens > 0:
                        tail_s = decode_evs[j].window(
                            tail_gen_tokens(req.trace))
                    if tail_s > 0:
                        self._span(req, "generate_tail", round_end,
                                   round_end + tail_s, rnd,
                                   wave_id=wave.wid)
                    complete_t = round_end + tail_s
                req.complete_t = complete_t
                self._span(req, "complete", complete_t, complete_t)
                self._push(complete_t, "mark",
                           (req, RequestState.COMPLETE, "complete"))
                wave_end = max(wave_end, complete_t)

        # the wave's modeled footprint on the clock ends at its slowest
        # member's round end (future-stamped; consumers sort by t)
        self.recorder.emit(WaveEvent(
            t=wave_end, kind="wave.complete", replica=self.replica_id,
            wave_id=wave.wid, tenant=wave.tenant, size=batch,
            request_ids=wave.request_ids, rounds=tuple(rounds),
            nbytes=nbytes))

        # 5) next round's query drifts from this round's rewrite
        for j in ret:
            rows = [r for r, o in enumerate(owners) if o == j]
            members[j].cur_q = q_out[rows[0]]

        # 6) never-re-form mode: the cohort's earliest finisher opens the
        #    shared next-round frontier (dynamic waves instead schedule
        #    per-request "ready" events above)
        if cohort is not None and continuing \
                and (rounds[0] + 1) not in cohort.scheduled_rounds:
            cohort.scheduled_rounds.add(rounds[0] + 1)
            self._push(min(continuing), "round", (cohort, rounds[0] + 1))

    def _generate_with_kv_relief(self, members, gen_tokens, rnd: int, *,
                                 tenant: str):
        """Run the decode hook; on a *pool-bytes* shortfall
        (``PoolExhausted.bytes_needed > 0``) evict cold unpinned
        prefetch residency toward the failed lease's size and retry
        once.  With paged decode the KV bytes return to the pool
        between waves, so warm prefetch residency physically creeps
        into them (the dense bucket held its pages forever and never
        exposed this) — the cold tail is exactly what ``plannable_pages``
        already promised generation state could reclaim.  Slab
        free-list exhaustion (``bytes_needed == 0``) is not curable by
        eviction and propagates to the shed/park path, as does a
        second failure after the spill."""
        try:
            return self.on_generate(list(members), list(gen_tokens), rnd)
        except PoolExhausted as exc:
            needed = getattr(exc, "bytes_needed", 0)
            if needed <= 0:
                raise
            eng = self.engine
            # the lease draws on *reservable* pages (free minus in-flight
            # admission reservations), so spill until the free list
            # covers the lease on top of everything already reserved
            pages = (-(-needed // eng.pool.page_nbytes)
                     + eng.pool.reserved_pages())
            eng.cache.make_room(eng.buffer, pages,
                                protect=eng.admission.spill_protect(tenant))
            return self.on_generate(list(members), list(gen_tokens), rnd)

    def _shed_on_kv_pressure(self, wave: _Wave, keys, hit_pins, fetch_pins,
                             ticket, *, now: float,
                             starts: Sequence[float]) -> None:
        """The decode hook's ``acquire_paged`` failed at this wave's
        round frontier: the KV slab/pool cannot hold the whole batch's
        block tables.  Shed half — the older half re-executes right now
        as its own smaller wave (re-planned from scratch; still too big
        and it sheds again, down to one), the younger half parks
        ``PRESSURE_STALLED`` and rejoins on the page-free event the
        running half's ``release_paged`` fires.  A singleton wave has
        no half to run: it parks whole — sound exactly when some OTHER
        holder will free pages through a future event (another wave's
        pins, an open KV lease, an outstanding reservation; checked
        after dropping this wave's own holds so they don't count as
        their own rescue).  With no such holder the exhaustion is
        structural and the original ``PoolExhausted`` propagates.  The
        original wave dissolves exactly like an admission park: this
        round's tentative pins are dropped, the reservation's remainder
        is returned, and the wave leaves the log (it never executed)."""
        eng = self.engine
        for m, pins in zip(keys, hit_pins):
            eng.buffer.release_pins(m, pins)
        for m, pins in zip(keys, fetch_pins):
            eng.buffer.release_pins(m, pins)
        if ticket is not None:
            # lookahead_ex commits on its own paths; pool.cancel is
            # idempotent so a second commit is a no-op
            eng.admission.commit(ticket)
        self.wave_log.remove(wave)
        keep = len(wave.members) // 2
        if keep == 0 and not eng.admission.holds_pending_release():
            raise       # re-raises the in-flight PoolExhausted
        parked = _Wave(wid=wave.wid, t=now, members=wave.members[keep:],
                       rounds=wave.rounds[keep:], tenant=wave.tenant,
                       kv_parked=True)
        eng.admission.park(parked, len(parked.members), tenant=wave.tenant)
        for m in parked.members:
            m.state = RequestState.PRESSURE_STALLED
            self._emit_req(now, "pressure_stall", m, wave_id=parked.wid)
        if keep:
            self._exec_wave(
                _Wave(wid=next(self._wid), t=now,
                      members=wave.members[:keep],
                      rounds=wave.rounds[:keep], tenant=wave.tenant),
                now=now, starts=list(starts[:keep]))

    # ---- admission / memory-pressure plumbing ------------------------------
    def _on_pages_freed(self, pages: int) -> None:
        """Pool subscriber: pages returned to the free list wake parked
        requests (runs inside whichever event handler freed them)."""
        if self.engine.admission.parked and not self._retry_scheduled:
            self._retry_scheduled = True
            self._push(self._now, "retry", ())

    def _retry_parked(self, now: float, force: bool = False) -> None:
        """Wake every parked request.  The stall interval becomes a
        ``pressure_stall`` span and the round restarts from the resume
        time, so admission delay shows up in admit→complete latency.
        Dynamically-formed waves dissolve on wake: their members rejoin
        whatever wave the resume frontier forms (possibly alongside
        requests admitted while they slept)."""
        woke_ready = False
        for key, _npages in self.engine.admission.unpark_all():
            if isinstance(key, _Wave):
                for j, m in enumerate(key.members):
                    # KV-parked waves wake EVERY member: their decode
                    # (tail members included) never ran.  Admission
                    # parks ran tail members as their own wave before
                    # parking, so those stay skipped.
                    if not key.kv_parked and key.rounds[j] >= len(m.plan):
                        continue
                    rs = m.ready_t
                    if now > rs + 1e-15:
                        self._span(m, "pressure_stall", rs, now,
                                   key.rounds[j], wave_id=key.wid)
                    m.ready_t = now
                    m.state = RequestState.ADMITTED
                    self._emit_req(now, "pressure_resume", m)
                    self._ready.append(m)
                    woke_ready = True
            else:
                g, rnd = key
                for m in g.members:
                    if rnd >= len(m.plan):
                        continue
                    rs = m.round_start[rnd]
                    if now > rs + 1e-15:
                        self._span(m, "pressure_stall", rs, now, rnd)
                        m.round_start[rnd] = now
                    m.state = RequestState.ADMITTED
                    self._emit_req(now, "pressure_resume", m)
                self._push(now, "round", (g, rnd, force))
        if woke_ready:
            self._push(now, "frontier", (force,))

    def _on_member_complete(self, rec: RequestRecord, t: float) -> None:
        """Completion event: the request releases its own cluster pins
        (re-keyed from wave-id to request-id — pages a whole wave
        shared become evictable when their LAST holder completes), and
        the per-request completion hook fires."""
        freed = self.engine.buffer.unpin(rec)
        if self.on_complete is not None:
            self.on_complete(rec)
        # wake parked requests only when this release actually made
        # pages evictable (the LAST pin holder of a shared working set
        # dropping out) — an intermediate wave-mate's completion frees
        # nothing and must not thrash park/re-park cycles
        if freed and self.engine.admission.parked \
                and not self._retry_scheduled:
            self._retry_scheduled = True
            self._push(t, "retry", ())
