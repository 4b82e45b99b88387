"""Retrieval execution policies — the paper's comparison systems as a
strategy layer (§3.2, §4.1, Fig. 5).

Each policy bundles the two planes that the legacy ``TeleRAGEngine``
scattered across ``if mode == ...`` branches:

  * **data plane** — how a round's retrieval actually executes against
    the engine's buffer/cache/index (``lookahead`` / ``retrieve``);
  * **timing plane** — how the round's measured telemetry composes into
    modeled wall-clock (``transfer_ready_offset`` / ``search_seconds``),
    which the event-driven ``RetrievalRuntime`` consumes as dependency
    edges and the legacy ``RequestResult.latency`` sums per round.

Adding a baseline is one ``@register_policy`` class, not edits to the
engine, the telemetry math, and the executor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.hybrid_search import RetrievalResult, host_search, hybrid_retrieve
from repro_torch.core.ivf import probe
from repro_torch.core.lookahead import PrefetchPlan, plan_batched_prefetch
from repro_torch.core.transfer import TransferEvent
from repro_torch.memory.admission import AdmissionTicket

if TYPE_CHECKING:                                    # avoid circular import
    from repro_torch.serving.engine import RoundTelemetry, TeleRAGEngine


@dataclass(frozen=True)
class LatencyContext:
    """Hardware constants the timing plane composes telemetry with."""

    t_cc: float                  # host per-cluster search seconds
    cluster_bytes: float         # mean cluster payload (demand-fetch model)
    link_bw: float               # H2D link bandwidth for demand fetches

    @classmethod
    def from_engine(cls, engine: "TeleRAGEngine") -> "LatencyContext":
        """Read the constants off a live engine (t_cc seconds/cluster,
        mean cluster bytes, link bytes/second)."""
        return cls(
            t_cc=engine.effective_tcc(),
            cluster_bytes=float(
                np.mean(engine.index.paged.all_cluster_bytes())),
            link_bw=float(engine.cfg.hw.host_link_bw))


class RetrievalPolicy:
    """Base strategy; concrete policies override both planes."""

    name: str = ""
    prefetches: bool = False     # does lookahead dispatch an async copy?

    # ---- data plane -------------------------------------------------------
    def plan(self, engine: "TeleRAGEngine", q_in: np.ndarray,
             gen_tokens: Sequence[int], *,
             free_pages: Optional[int] = None, ranked=None,
             wave_key: object = None) -> Optional[PrefetchPlan]:
        """The *desired* lookahead plan (what the wave wants to reserve),
        computed against the pool's full extent — transient pressure is
        the admission controller's problem, not the planner's.  None for
        non-prefetching policies.  ``wave_key`` identifies the wave's
        own buffer pins so the plan never counts them as reclaimable:
        under per-request continuous batching it is the tuple of the
        wave's member records (pins are keyed per request and released
        at each request's own completion), not a wave id."""
        return None

    def lookahead(self, engine: "TeleRAGEngine", q_in: np.ndarray,
                  gen_tokens: Sequence[int], *, now: float = 0.0,
                  plan: Optional[PrefetchPlan] = None,
                  ticket: Optional[AdmissionTicket] = None,
                  tenant: str = "shared",
                  ) -> Tuple[int, int, Optional[TransferEvent]]:
        """Plan + dispatch prefetch. Returns (bytes_planned, clusters,
        transfer event). Non-prefetching policies are a no-op.
        ``tenant`` is who a direct caller's synchronous admission (no
        precomputed ``ticket``) charges its reservation to."""
        return 0, 0, None

    def retrieve(self, engine: "TeleRAGEngine", q_out: np.ndarray, *,
                 now: float = 0.0,
                 tenant: str = "shared") -> RetrievalResult:
        """Execute the round's retrieval for the rewritten queries at
        event-clock time ``now`` (seconds).  ``tenant`` is the
        requesting wave's tenant — policies that evict to make room
        (demand fetch) must scope the eviction to its floor view."""
        raise NotImplementedError

    # ---- timing plane -----------------------------------------------------
    def transfer_ready_offset(self, rt: "RoundTelemetry",
                              ctx: LatencyContext) -> Optional[float]:
        """Seconds after round start at which prefetched data is usable;
        None when retrieval has no transfer dependency."""
        return None

    def search_seconds(self, rt: "RoundTelemetry",
                       ctx: LatencyContext) -> float:
        """Retrieval critical path once its dependencies are met."""
        raise NotImplementedError

    def round_latency(self, rt: "RoundTelemetry",
                      ctx: LatencyContext) -> float:
        """Round wall-clock from the dependency decomposition.  Identical
        to the legacy closed forms (``RoundTelemetry.t_*``) by
        construction — asserted in tests/test_runtime.py."""
        off = self.transfer_ready_offset(rt, ctx)
        start = rt.t_llm_window if off is None else max(rt.t_llm_window, off)
        return start + self.search_seconds(rt, ctx)

    # ---- shared data-plane helpers ---------------------------------------
    @staticmethod
    def _hybrid_retrieve(engine: "TeleRAGEngine", q_out: np.ndarray,
                         ranked_out: np.ndarray) -> RetrievalResult:
        res = hybrid_retrieve(engine.buffer, q_out, ranked_out,
                              k=engine.cfg.top_k,
                              fused=engine.cfg.fused_retrieval,
                              centroids=engine.index.device_centroids)
        used = [c for h in res.hit_clusters for c in h]
        engine.cache.record_lookup([c for r in ranked_out for c in r],
                                   engine.buffer.resident_clusters())
        engine.cache.round_update(used)
        return res


_POLICIES: Dict[str, RetrievalPolicy] = {}


def register_policy(cls: Type[RetrievalPolicy]) -> Type[RetrievalPolicy]:
    """Class decorator: instantiate and register a policy under its
    ``name`` (how a new baseline plugs in without engine edits)."""
    _POLICIES[cls.name] = cls()
    return cls


def get_policy(mode: str) -> RetrievalPolicy:
    """The registered policy instance for ``mode`` (KeyError if none)."""
    if mode not in _POLICIES:
        raise KeyError(mode)
    return _POLICIES[mode]


def policy_names() -> Tuple[str, ...]:
    """Registered policy names (the valid ``EngineConfig.mode`` values)."""
    return tuple(_POLICIES)


@register_policy
class TeleRAGPolicy(RetrievalPolicy):
    """Lookahead prefetch overlapped with generation + hybrid search."""

    name = "telerag"
    prefetches = True

    def plan(self, engine, q_in, gen_tokens, *, free_pages=None,
             ranked=None, wave_key=None):
        B = q_in.shape[0]
        bud = engine.prefetch_budget(gen_tokens, B)
        if ranked is None:
            ranked = probe(q_in, engine.index,
                           min(engine.cfg.lookahead_rank,
                               engine.index.num_clusters))
        resident = engine.buffer.resident_clusters()
        # plan against the wave's plannable extent (not transient free
        # slots): how many pages it can actually have right now is the
        # admission controller's reserve/stall/spill decision, never a
        # silent clamp inside the planner
        if free_pages is None:
            hits = {int(c) for row in ranked for c in row} & resident
            free_pages = engine.plannable_pages(wave_key,
                                                hit_clusters=hits)
        plan, _ = plan_batched_prefetch(
            list(ranked), engine.index.paged, budget_bytes=bud,
            resident=resident, free_pages=free_pages)
        plan.ranked = ranked
        return plan

    def lookahead(self, engine, q_in, gen_tokens, *, now=0.0, plan=None,
                  ticket=None, tenant="shared"):
        if plan is None:
            plan = self.plan(engine, q_in, gen_tokens)
        if ticket is None:
            # direct (non-runtime) callers cannot park on an event queue:
            # admit synchronously — spill, or cap with the shortfall on
            # the admission stats rather than dropping clusters silently
            # (tenant-attributed, so a direct caller's burst still counts
            # against its own floor/ceiling, not the shared sentinel's)
            ticket = engine.admission.admit(plan.pages_planned,
                                            owner="lookahead",
                                            can_wait=False,
                                            tenant=tenant)
        if ticket.capped and ticket.pages_granted < plan.pages_planned:
            plan = self.plan(engine, q_in, gen_tokens,
                             free_pages=ticket.pages_granted,
                             ranked=plan.ranked)
        try:
            if plan.fetch:
                # the dispatch-time fallback eviction must honor tenant
                # floors exactly like the admission spill does — otherwise
                # a full buffer at transfer time would let this wave dig
                # another tenant below its guaranteed floor
                protect = engine.admission.spill_protect(ticket.tenant)
                ev = engine.transfer.submit(
                    plan.fetch, now=now, nbytes=plan.bytes_planned,
                    reservation=ticket.reservation,
                    make_room=lambda pages: engine.cache.make_room(
                        engine.buffer, pages, protect=protect))
            else:
                # nothing to move: no link event (a 0-byte event could
                # still inherit a channel-queue wait), but fold any queued
                # device invalidations exactly as the legacy load path did
                engine.buffer.load_clusters([])
                ev = None
        finally:
            # ALWAYS return the reservation's unconsumed remainder — a
            # transfer that raises mid-submit must not leave reserved
            # pages stranded until the pool is rebuilt (telint TL001)
            engine.admission.commit(ticket)
        # only clusters that actually landed become cache-tracked — a
        # rejected cluster must not leak a hotness entry
        engine.cache.on_fetched(
            [c for c in plan.fetch if engine.buffer.is_resident(c)])
        # chunk-KV lookahead: land the predicted clusters' precomputed
        # chunk pages H2D during the same generation window, so the next
        # round's splice hits warm residency instead of re-prefilling.
        # Cold (unpinned) loads: a demoted ticket never reaches this
        # call, and pool pressure can evict them again (the engine spill
        # chain protects only pinned chunks).
        chunk = getattr(engine, "chunk_kv", None)
        if chunk is not None and engine.cfg.chunk_kv_prefetch_pages > 0:
            if plan.fetch:
                clusters = list(plan.fetch) + list(plan.resident_hits)
            elif plan.ranked is not None:
                clusters = [int(c) for c in np.asarray(plan.ranked).ravel()[:8]]
            else:
                clusters = []
            if clusters:
                chunk.prefetch_clusters(
                    clusters, tenant=ticket.tenant,
                    budget_pages=engine.cfg.chunk_kv_prefetch_pages)
        return plan.bytes_planned, len(plan.fetch), ev

    def retrieve(self, engine, q_out, *, now=0.0, tenant="shared"):
        """Hybrid retrieval: device search over resident hits + host
        search over misses (no eviction at retrieval time)."""
        ranked_out = probe(q_out, engine.index, engine.cfg.nprobe)
        return self._hybrid_retrieve(engine, q_out, ranked_out)

    def transfer_ready_offset(self, rt, ctx):
        return rt.t_prefetch

    def search_seconds(self, rt, ctx):
        return max(rt.t_host_search, rt.t_dev_search) + rt.t_merge


@register_policy
class CpuBaselinePolicy(RetrievalPolicy):
    """Retrieval entirely on host (Faiss-CPU baseline)."""

    name = "cpu_baseline"

    def retrieve(self, engine, q_out, *, now=0.0, tenant="shared"):
        """Search every probed cluster on host (no device state)."""
        ranked_out = probe(q_out, engine.index, engine.cfg.nprobe)
        res_s, res_i, miss = [], [], []
        for b in range(q_out.shape[0]):
            cs = [int(c) for c in ranked_out[b]]
            s, i = host_search(engine.index.paged, cs, q_out[b],
                               engine.cfg.top_k)
            res_s.append(s)
            res_i.append(i)
            miss.append(cs)
        return RetrievalResult(doc_ids=np.stack(res_i),
                               scores=np.stack(res_s),
                               hit_clusters=[[] for _ in miss],
                               missed_clusters=miss,
                               nprobe=engine.cfg.nprobe)

    def search_seconds(self, rt, ctx):
        return (rt.hits + rt.misses) * ctx.t_cc


@register_policy
class RuntimeFetchPolicy(RetrievalPolicy):
    """Fetch-on-demand at retrieval time — no overlap (§3.2, Fig. 5)."""

    name = "runtime_fetch"

    def retrieve(self, engine, q_out, *, now=0.0, tenant="shared"):
        """Demand-fetch every probed cluster at retrieval time, then
        run the hybrid search (no lookahead overlap).  The eviction
        that makes room honors other tenants' floors from the
        requesting ``tenant``'s view."""
        ranked_out = probe(q_out, engine.index, engine.cfg.nprobe)
        # fetch exactly the probed clusters now (not overlapped)
        need = sorted(set(int(c) for r in ranked_out for c in r))
        pages = sum(int(engine.index.paged.cluster_num_pages[c])
                    for c in need if not engine.buffer.is_resident(c))
        engine.cache.make_room(engine.buffer, pages,
                               protect=engine.admission.spill_protect(
                                   tenant))
        engine.transfer.submit(need, now=now, kind="demand",
                               nbytes=pages * engine.buffer.page_nbytes)
        return self._hybrid_retrieve(engine, q_out, ranked_out)

    def search_seconds(self, rt, ctx):
        nb = (rt.hits + rt.misses) * ctx.cluster_bytes
        return nb / ctx.link_bw + rt.t_dev_search + rt.t_merge
