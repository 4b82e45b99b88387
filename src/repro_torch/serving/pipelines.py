"""Legacy serving facades, now thin DEPRECATED shims over the unified
front-end in ``serving/api.py``.

``PipelineExecutor`` admits a whole micro-batch at t=0 into an
event-driven ``RetrievalRuntime`` running in the degenerate
*never-re-form* mode (``reform=False``: the admission group stays the
wave for every round) and drains it — byte-identical results to the
pre-runtime lockstep loop.

``MultiReplicaOrchestrator.run_global_batch`` routes through
``TeleRAGServer``: one simultaneous-arrival wave, grouped and routed by
the same ``SchedulerPolicy``, executed on the server's shared global
event clock.  Because the server serializes micro-batches within a
replica (with ``end_batch`` consolidation between them, exactly like the
old serial drain) the shim reproduces the legacy doc ids and round
telemetry to 1e-6 — pinned in tests/test_api.py.  New code should call
``TeleRAGServer.submit``/``drain`` directly: it is the same machinery
minus the blocking, closed-loop shape.

This module is a copy of the JAX package's module of the same path,
imports repointed.  The tests its comments name pin the JAX package's
copy; ``tests/test_torch_api.py`` holds this one to it.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ivf import IVFIndex
from repro_torch.core.schedulers import (ReplicaHealth, SchedulerPolicy,
                                         TeleRAGScheduler)
from repro_torch.serving.api import RagRequest, TeleRAGServer
from repro_torch.serving.engine import EngineConfig, RequestResult, TeleRAGEngine
from repro_torch.serving.runtime import (RequestRecord, RetrievalRuntime,
                                         round_plan, tail_gen_tokens)
from repro_torch.serving.trace import RequestTrace

PIPELINE_NAMES = ("hyde", "subq", "iter", "irg", "flare", "self_rag")


class PipelineExecutor:
    """DEPRECATED: executes micro-batches of traced requests on a single
    engine.  Use ``TeleRAGServer`` (serving/api.py) for new code."""

    def __init__(self, engine: TeleRAGEngine):
        warnings.warn(
            "PipelineExecutor is deprecated; use TeleRAGServer "
            "(repro_torch.serving.api) — same machinery, typed "
            "request/response lifecycle", DeprecationWarning, stacklevel=2)
        self.engine = engine
        # never-re-form mode: the admission group stays the wave for
        # every round, which pins the legacy lockstep results exactly
        self.runtime = RetrievalRuntime(engine, reform=False)
        self.last_records: List[RequestRecord] = []

    def execute_batch(self, q_in: np.ndarray, traces: Sequence[RequestTrace],
                      ) -> List[RequestResult]:
        """q_in: [B, d] initial query embeddings; one trace per query."""
        assert q_in.shape[0] == len(traces)
        recs = [self.runtime.submit(q_in[i], traces[i])
                for i in range(len(traces))]
        self.runtime.run()
        self.last_records = recs
        return [r.result for r in recs]

    @staticmethod
    def _round_plan(trace: RequestTrace) -> List[Tuple[int, int]]:
        """[(gen_tokens_before_retrieval, num_queries), ...] per round."""
        return round_plan(trace)

    @staticmethod
    def tail_gen_tokens(trace: RequestTrace) -> int:
        """Generation after the last retrieval (counts once per request)."""
        return tail_gen_tokens(trace)


# ---------------------------------------------------------------------------
# Multi-replica orchestration (Fig. 7) — legacy report + shim
# ---------------------------------------------------------------------------


@dataclass
class GlobalBatchReport:
    per_replica_results: Dict[int, List[RequestResult]]
    schedule_overhead_s: float
    assignments: List[Tuple[int, int, int]]      # (batch_idx, replica, overlap)
    requeued: List[int] = field(default_factory=list)
    records: List[RequestRecord] = field(default_factory=list)
    submission_ids: List[int] = field(default_factory=list)

    def all_results(self) -> List[RequestResult]:
        """All requests' results in *submission order* (when the report
        carries it) — never in replica-dict iteration order."""
        out: List[RequestResult] = []
        for rs in self.per_replica_results.values():
            out.extend(rs)
        if self.submission_ids:
            pos = {rid: i for i, rid in enumerate(self.submission_ids)}
            out.sort(key=lambda r: pos.get(r.request_id, len(pos)))
        return out


class MultiReplicaOrchestrator:
    """DEPRECATED facade: the Fig.-7 orchestration now lives in
    ``TeleRAGServer`` (a continuous cross-replica dispatcher on a shared
    event clock).  This class keeps the old constructor surface and a
    ``run_global_batch`` shim for closed-loop batch replay; reach the
    server itself at ``.server`` (or construct one directly)."""

    def __init__(self, index: IVFIndex, cfg: EngineConfig, num_replicas: int,
                 arch=None, *, scheduler: Optional[SchedulerPolicy] = None,
                 use_prefetch_sched: bool = True,
                 use_cache_sched: bool = True):
        self.server = TeleRAGServer(
            index, cfg, num_replicas, arch,
            scheduler=scheduler or TeleRAGScheduler(
                similarity_grouping=use_prefetch_sched,
                cache_aware=use_cache_sched))
        self.index = index
        self.health = ReplicaHealth()

    @property
    def replicas(self) -> List[TeleRAGEngine]:
        """The server's replica engines (legacy attribute name)."""
        return self.server.engines

    @property
    def scheduler(self) -> SchedulerPolicy:
        """The server's SchedulerPolicy (legacy attribute name)."""
        return self.server.scheduler

    @property
    def nprobe_for_sched(self) -> int:
        """Clusters probed per query for routing hints (legacy name)."""
        return self.server.nprobe_for_sched

    def run_global_batch(self, q_in: np.ndarray,
                         traces: Sequence[RequestTrace], *,
                         micro_batch: int = 4,
                         dead_replicas: Optional[set] = None,
                         ) -> GlobalBatchReport:
        """DEPRECATED: serve one simultaneous-arrival wave through the
        server and translate the responses back into the legacy
        ``GlobalBatchReport`` shape (doc ids exact, telemetry pinned to
        1e-6 against the old serial drain in tests/test_api.py)."""
        warnings.warn(
            "run_global_batch is deprecated; submit RagRequests to "
            "TeleRAGServer and drain() — closed-loop batch replay is one "
            "simultaneous-arrival wave", DeprecationWarning, stacklevel=2)
        srv = self.server
        prev_mb, srv.micro_batch = srv.micro_batch, micro_batch
        # the per-call argument ADDS to replicas already mark_dead()ed on
        # the server — it must never silently resurrect one of them
        prev_dead = set(srv.dead)
        srv.dead = prev_dead | set(dead_replicas or ())
        wave_start = len(srv.wave_log)
        try:
            responses = srv.serve([RagRequest(q=q_in[i], trace=traces[i])
                                   for i in range(len(traces))])
        finally:
            srv.micro_batch, srv.dead = prev_mb, prev_dead
        waves = srv.wave_log[wave_start:]
        dead = prev_dead | set(dead_replicas or ())
        per_replica: Dict[int, List[RequestResult]] = {
            i: [] for i in range(len(srv.engines)) if i not in dead}
        for resp, rec in zip(responses, srv.last_records):
            per_replica.setdefault(resp.replica, []).append(rec.result)
        return GlobalBatchReport(
            per_replica_results=per_replica,
            schedule_overhead_s=sum(w.sched_overhead_s for w in waves),
            assignments=[a for w in waves for a in w.assignments],
            requeued=[b for w in waves for b in w.requeued],
            records=list(srv.last_records),
            submission_ids=[t.request_id for t in traces])
