"""TeleRAG serving engine (paper §4, Fig. 6/7).

Resource owner + retrieval primitives for one replica ("GPU"):
prefetch buffer, cluster cache, budget policy, LLM backend, and the
timing model that composes measured byte/hit-rate telemetry into
modeled wall-clock per the paper's overlap semantics:

    t1 = max(t_llm_window, t_prefetch)          (§4.1 / App. C)
    t2 = max(t_host_search(misses), t_dev_search(hits)) + t_merge

Three execution modes cover the paper's comparison systems:
  * "telerag"        — lookahead prefetch + hybrid search (ours)
  * "cpu_baseline"   — retrieval entirely on host (Faiss-CPU baseline)
  * "runtime_fetch"  — fetch-on-demand at retrieval time (§3.2, Fig. 5)
Mode behaviour lives in serving/policies.py (``RetrievalPolicy``); the
engine owns the resources and delegates, and async H2D copies go through
``core/transfer.py``'s ``TransferEngine`` as timestamped events.

Quantities that are *measured* on this container: bytes moved, cluster
hit/miss sets, search results, scheduler quality. Wall-clock is modeled
from the HardwareProfile (CPU-only container; see DESIGN.md §7) — except
host search, whose per-cluster cost t_cc can be measured and plugged in.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import budget as budget_mod
from repro_torch.core.budget import H100, HardwareProfile
from repro_torch.core.cache import CacheConfig, ClusterCache
from repro_torch.core.datastore import PagedClusters
from repro_torch.core.hybrid_search import RetrievalResult, host_search
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.prefetch_buffer import PrefetchBuffer
from repro_torch.core.transfer import TransferEngine, TransferEvent
from repro_torch.memory.admission import AdmissionController, AdmissionStats
from repro_torch.memory.ledger import MemoryLedger
from repro_torch.memory.pool import DevicePagePool
from repro_torch.obs.clock import EventClock
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.serving.policies import (LatencyContext, RetrievalPolicy,
                                    get_policy)


@dataclass
class EngineConfig:
    nprobe: int = 256
    top_k: int = 3
    buffer_pages: int = 1024
    pool_pages: Optional[int] = None              # None => buffer_pages (one
                                                  # shared slab, legacy sizing)
    prefetch_budget_bytes: Optional[int] = None   # None => Appendix-C policy
    lookahead_rank: int = 512                     # clusters ranked by q_in
    mode: str = "telerag"                         # telerag|cpu_baseline|runtime_fetch
    fused_retrieval: bool = True                  # one-launch probe+topk on the
                                                  # device partition (False =
                                                  # legacy host-mask two-launch)
    cache: CacheConfig = field(default_factory=CacheConfig)
    cache_enabled: bool = False                   # paper: off on single GPU
    paged_decode: bool = True                     # serve decode over block-
                                                  # table KV (False pins the
                                                  # legacy dense [B,S] path)
    chunk_kv: bool = False                        # splice precomputed chunk-KV
                                                  # pages into paged decode
                                                  # (needs a ChunkKVStore on
                                                  # the DecodeRunner)
    chunk_kv_docs: int = 4                        # max docs spliced per row
    chunk_kv_prefetch_pages: int = 16             # lookahead chunk-page burst
                                                  # per round (0 = no chunk
                                                  # prefetch)
    hw: HardwareProfile = H100
    chips: int = 1
    t_cc: Optional[float] = None                  # None => bytes/host_mem_bw
    seed: int = 0
    # multi-tenant pool entitlements: tenant -> (floor_pages, max_pages)
    # (max_pages None = may burst to the whole pool); None/{} = the
    # legacy single-tenant pool
    tenant_shares: Optional[Dict[str, Tuple[int, Optional[int]]]] = None


@dataclass
class RoundTelemetry:
    round_index: int
    batch: int                        # wave size the round executed at
    gen_tokens: int
    t_llm_window: float = 0.0
    bytes_prefetched: int = 0
    t_prefetch: float = 0.0
    hits: int = 0
    misses: int = 0
    t_host_search: float = 0.0
    t_dev_search: float = 0.0
    t_merge: float = 0.0
    # per-request round identity on the event clock (continuous
    # batching: a request's rounds run in different waves, so round
    # telemetry is keyed by request, stamped with the wave it rode)
    wave_id: int = -1                 # dynamic wave that ran this round
    round_start_t: float = float("nan")   # absolute event-clock round start
    round_end_t: float = float("nan")     # absolute event-clock round end

    # composed stage latencies under each system's overlap semantics
    def t_telerag(self) -> float:
        """Round seconds under TeleRAG overlap: max(gen, prefetch) +
        max(host, device search) + merge (§4.1 / App. C)."""
        t1 = max(self.t_llm_window, self.t_prefetch)
        t2 = max(self.t_host_search, self.t_dev_search) + self.t_merge
        return t1 + t2

    def t_cpu_baseline(self, t_cc: float) -> float:
        """Round seconds with all retrieval on host at ``t_cc`` seconds
        per cluster (no overlap)."""
        return self.t_llm_window + (self.hits + self.misses) * t_cc

    def t_runtime_fetch(self, page_bytes_per_cluster: float,
                        link_bw: float) -> float:
        """Round seconds for demand-fetch at retrieval time: every
        probed cluster crosses the link before the device search."""
        nb = (self.hits + self.misses) * page_bytes_per_cluster
        return (self.t_llm_window + nb / link_bw
                + self.t_dev_search + self.t_merge)


@dataclass
class RequestResult:
    request_id: int
    pipeline: str
    doc_ids: List[np.ndarray] = field(default_factory=list)
    rounds: List[RoundTelemetry] = field(default_factory=list)

    def latency(self, mode: str, *, t_cc: float, cluster_bytes: float,
                link_bw: float, tail_gen_s: float = 0.0) -> float:
        """Legacy closed-form composition, now via the policy registry —
        a new baseline is one policy class, not another elif here."""
        policy = get_policy(mode)
        ctx = LatencyContext(t_cc=t_cc, cluster_bytes=cluster_bytes,
                             link_bw=link_bw)
        return tail_gen_s + sum(policy.round_latency(r, ctx)
                                for r in self.rounds)


class TeleRAGEngine:
    """Single-replica engine: prefetch buffer + cache + hybrid retrieval."""

    def __init__(self, index: IVFIndex, cfg: EngineConfig,
                 arch: Optional[ArchConfig] = None, *,
                 wall_clock=None):
        self.index = index
        self.cfg = cfg
        self.arch = arch
        # every engine records; a standalone engine owns its recorder,
        # a server rebinds all replicas onto one shared stream
        self.recorder = FlightRecorder()
        self.replica_id = -1
        # wall-clock discipline: real time is an injected dependency
        # (launch drivers pass obs.clock.SystemClock); the default
        # EventClock keeps runs replay-deterministic
        self.wall = wall_clock if wall_clock is not None \
            else EventClock(self.recorder)
        self._init_memory()
        self.transfer = TransferEngine(self.buffer, cfg.hw.host_link_bw)
        self.cache = ClusterCache(cfg.cache)
        self._wire_recorder()
        self._rng = np.random.default_rng(cfg.seed)
        self._measured_tcc: Optional[float] = None

    def _wire_recorder(self) -> None:
        """Point every emitting component at the engine's recorder."""
        for comp in (self.pool, self.admission, self.transfer):
            comp.recorder = self.recorder
            comp.replica_id = self.replica_id

    def attach_recorder(self, recorder: FlightRecorder,
                        replica: int = -1) -> None:
        """Rebind onto a shared flight recorder (the server attaches one
        recorder across all replicas, each with its lane id)."""
        self.recorder = recorder
        self.replica_id = replica
        if isinstance(self.wall, EventClock):
            self.wall.recorder = recorder
        self._wire_recorder()

    def _init_memory(self) -> None:
        """One HBM arbiter per replica: page pool + byte ledger +
        admission control, shared by prefetch buffer and KV cache."""
        cfg = self.cfg
        self.ledger = MemoryLedger(
            capacity_bytes=int(cfg.hw.hbm_bytes * cfg.chips))
        if self.arch is not None:
            # resident model weights compete for the same HBM (bf16)
            self.ledger.charge("weights", self.arch.param_count() * 2)
        # the slab lives where the index was built (``build_ivf(device=)``)
        self.pool = DevicePagePool(
            self.index.paged, cfg.pool_pages or cfg.buffer_pages,
            ledger=self.ledger, device=self.index.device)
        self.buffer = PrefetchBuffer(self.index.paged, pool=self.pool,
                                     quota_pages=cfg.buffer_pages)
        for tenant, share in (cfg.tenant_shares or {}).items():
            floor, cap = (share if isinstance(share, (tuple, list))
                          else (share, None))
            self.pool.set_tenant_share(tenant, floor, cap)
        self.admission = AdmissionController(
            self.pool,
            spill=lambda target, protect=None: self._spill(target, protect))
        # chunk-KV residency (set by DecodeRunner.attach when enabled);
        # a memory rebuild (restart) loses on-device chunk pages, so the
        # stale cache must not survive it — the hook re-attaches
        self.chunk_kv = None

    def _spill(self, target: int, protect=None) -> List[int]:
        """Admission's page-reclaim chain: evict unpinned prefetch
        residency first (existing slack rules), then cold chunk-KV
        residency — pinned chunks, like in-flight wave pins, are
        protected (evicting them would orphan live block tables).
        ``target`` is a free-page goal; the controller measures what
        actually freed, so the return (evicted clusters) is advisory."""
        evicted = self.cache.make_room(self.buffer, target, protect=protect)
        if self.chunk_kv is not None and self.pool.free_pages() < target:
            self.chunk_kv.evict_cold(target - self.pool.free_pages())
        return evicted

    @property
    def policy(self) -> RetrievalPolicy:
        """Execution strategy for cfg.mode (resolved live so tests can
        flip the mode on an existing engine)."""
        return get_policy(self.cfg.mode)

    # ---- budget -----------------------------------------------------------
    @property
    def prefetch_capacity_bytes(self) -> int:
        """The prefetch share of the pool (its quota), not the whole
        slab — budgets must not grow just because the pool also hosts
        KV leases or extra headroom."""
        return self.cfg.buffer_pages * self.buffer.page_nbytes

    def prefetch_budget(self, gen_tokens: Sequence[int], batch: int) -> int:
        """The round's lookahead byte budget: an explicit override, the
        Appendix-C optimal policy (when an arch is set), or half the
        prefetch capacity."""
        if self.cfg.prefetch_budget_bytes is not None:
            return self.cfg.prefetch_budget_bytes
        if self.arch is None:
            return self.prefetch_capacity_bytes // 2
        return budget_mod.optimal_budget(
            self.arch, self.cfg.hw, gen_tokens=list(gen_tokens) or [0],
            batch=batch, nprobe=self.cfg.nprobe, t_cc=self.effective_tcc(),
            chips=self.cfg.chips,
            hbm_headroom_bytes=float(self.prefetch_capacity_bytes))

    def effective_tcc(self) -> float:
        """Host per-cluster search seconds: measured (calibrate_tcc) >
        configured (cfg.t_cc) > modeled from host memory bandwidth."""
        if self._measured_tcc is not None:
            return self._measured_tcc
        if self.cfg.t_cc is not None:
            return self.cfg.t_cc
        avg_cluster_bytes = float(np.mean(self.index.paged.all_cluster_bytes()))
        return budget_mod.host_cluster_search_seconds(avg_cluster_bytes,
                                                      self.cfg.hw)

    def calibrate_tcc(self, n_clusters: int = 16) -> float:
        """Measure real host per-cluster search cost on this machine
        via the injected wall clock.  Under the default deterministic
        ``EventClock`` the bracketing reads are equal, so the modeled
        per-cluster cost is stored instead — calibration is then a
        deterministic no-op rather than a zero that would erase host
        search time from every latency model downstream."""
        q = self._rng.standard_normal(self.index.dim).astype(np.float32)
        cs = list(range(min(n_clusters, self.index.num_clusters)))
        t0 = self.wall.perf()
        host_search(self.index.paged, cs, q, k=8)
        elapsed = self.wall.perf() - t0
        if elapsed > 0.0:
            self._measured_tcc = elapsed / len(cs)
        else:
            self._measured_tcc = self.effective_tcc()
        return self._measured_tcc

    # ---- timing primitives --------------------------------------------------
    def llm_window_seconds(self, gen_tokens: int, batch: int,
                           kv_len: int = 1024) -> float:
        """Modeled decode seconds for one generation window of
        ``gen_tokens`` at the given batch size (0.0 with no arch)."""
        if self.arch is None or gen_tokens == 0:
            return 0.0
        per = budget_mod.decode_step_seconds(self.arch, self.cfg.hw,
                                             batch=batch, kv_len=kv_len,
                                             chips=self.cfg.chips)
        return per * gen_tokens

    def _dev_search_seconds(self, pages_searched: int) -> float:
        nb = pages_searched * self.buffer.page_nbytes
        return nb / (self.cfg.hw.hbm_bw * self.cfg.chips) + 5e-6

    # ---- primitives ---------------------------------------------------------
    def plannable_pages(self, wave_key: object = None,
                        hit_clusters: Sequence[int] = ()) -> int:
        """Pages a wave's *desired* plan may target — never a silent
        clamp to transiently-free slots.  ``wave_key`` identifies the
        wave's own pins: a single pin key, or (continuous batching) a
        tuple of the wave's per-request pin keys.  Plannable capacity
        is:

          * physically free slots, plus
          * pages pinned by *other* in-flight waves (their completion
            events release them — exactly what a PRESSURE_STALLED wave
            waits for), plus
          * unpinned residency beyond the cache's protection quota
            (cold leftovers the admission spill may evict right now).

        Excluded: KV leases (generation state is not a fetch target),
        the wave's own pinned working set (already its hits), the
        ``hit_clusters`` this very plan will count as device hits (the
        wave pins them before admission, so their pages can never be
        reclaimed for its own fetches), and the hot residency the cache
        quota protects (displacing it would defeat Appendix D's cache).
        ``cfg.buffer_pages`` additionally bounds the prefetch share of a
        pool larger than it (shared with KV) so lookahead cannot starve
        generation state; under the default sizing (pool ==
        buffer_pages) the bound equals the free+reclaimable term."""
        waitable, spillable = self.buffer.reclaimable_split(wave_key,
                                                            hit_clusters)
        protected = (min(self.cache.quota_pages(self.buffer), spillable)
                     if self.cfg.cache_enabled else 0)
        reclaimable = waitable + (spillable - protected)
        quota_left = (self.cfg.buffer_pages
                      - (self.pool.leased_pages("prefetch") - reclaimable))
        return max(0, min(self.pool.free_pages() + reclaimable, quota_left))

    def plan_lookahead(self, q_in: np.ndarray, gen_tokens: Sequence[int], *,
                       wave_key: object = None):
        """The wave's *desired* prefetch plan (None for non-prefetching
        policies) — what admission control reserves headroom for."""
        return self.policy.plan(self, q_in, gen_tokens, wave_key=wave_key)

    def lookahead_ex(self, q_in: np.ndarray, gen_tokens: Sequence[int], *,
                     now: float = 0.0, plan=None, ticket=None,
                     tenant: str = "shared",
                     ) -> Tuple[int, int, Optional[TransferEvent]]:
        """Plan + dispatch prefetch for a micro-batch of q_in embeddings.

        Returns (bytes_planned, clusters_fetched, transfer event). Async
        by construction: device_put/scatter dispatch returns before the
        copy completes, so the subsequent decode steps overlap with it
        (the real mechanism, not only the model); the event's
        [start_t, end_t) window is the modeled link occupancy the
        RetrievalRuntime orders against generation windows.  ``plan`` /
        ``ticket`` carry a precomputed plan and its granted admission
        (the runtime reserves before dispatch); direct callers omit them
        and get synchronous spill-or-cap admission."""
        return self.policy.lookahead(self, q_in, gen_tokens, now=now,
                                     plan=plan, ticket=ticket, tenant=tenant)

    def lookahead(self, q_in: np.ndarray, gen_tokens: Sequence[int], *,
                  tenant: str = "shared") -> Tuple[int, int]:
        """Legacy two-value lookahead: (bytes_planned, clusters_fetched)
        with synchronous spill-or-cap admission."""
        nbytes, nfetch, _ = self.lookahead_ex(q_in, gen_tokens, tenant=tenant)
        return nbytes, nfetch

    def retrieve(self, q_out: np.ndarray, *, now: float = 0.0,
                 tenant: str = "shared") -> RetrievalResult:
        """Run the mode policy's retrieval for the rewritten queries at
        event-clock time ``now`` (seconds); ``tenant`` scopes any
        demand-fetch eviction to the requester's floor view."""
        return self.policy.retrieve(self, q_out, now=now, tenant=tenant)

    def end_batch(self) -> None:
        """Post-batch consolidation (paper App. D reproducibility rule)."""
        if self.cfg.cache_enabled:
            self.cache.consolidate(self.buffer)
        else:
            evict = list(self.buffer.resident_clusters())
            self.buffer.evict_clusters(evict)
            self.cache.hotness.clear()

    # ---- fault tolerance ------------------------------------------------------
    def snapshot(self) -> dict:
        """Host-side state capture (residency, hotness, lifetime stats,
        ledger, admission counters) for replica restart."""
        return {
            "hotness": dict(self.cache.hotness),
            "resident": sorted(self.buffer.resident_clusters()),
            "stats": (self.buffer.stats.bytes_h2d, self.buffer.stats.pages_h2d,
                      self.buffer.stats.rounds),
            "ledger": self.ledger.snapshot(),
            "admission": dataclasses.asdict(self.admission.stats),
            "admission_per_tenant": {
                t: dataclasses.asdict(s)
                for t, s in self.admission.per_tenant.items()},
        }

    def restore(self, snap: dict) -> None:
        """Rebuild device state from a snapshot (replica restart)."""
        old_pool = self.pool
        self._init_memory()
        # long-lived runtimes subscribed to the old pool must keep
        # receiving page-free events from the replacement
        self.pool.rebind_subscribers(old_pool)
        self.transfer = TransferEngine(self.buffer, self.cfg.hw.host_link_bw)
        self.cache = ClusterCache(self.cfg.cache)
        # fresh pool/admission/transfer must keep emitting into the
        # same trace stream across the restart
        self._wire_recorder()
        self.buffer.load_clusters(snap["resident"])
        self.cache.hotness.update({int(k): v for k, v in
                                   snap["hotness"].items()})
        b, p, r = snap["stats"]
        self.buffer.stats.bytes_h2d = b
        self.buffer.stats.pages_h2d = p
        self.buffer.stats.rounds = r
        # a restarted replica must not silently zero its admission
        # telemetry — aggregate AND per-tenant slices (older snapshots
        # without the keys keep the fresh zeros)
        if "admission" in snap:
            self.admission.stats = AdmissionStats(**snap["admission"])
        for t, s in snap.get("admission_per_tenant", {}).items():
            self.admission.per_tenant[t] = AdmissionStats(**s)
