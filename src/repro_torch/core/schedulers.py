"""TeleRAG's two schedulers (paper §4.2, Fig. 7), plus the SLO layer.

Prefetching scheduler: greedily groups semantically similar queries into
micro-batches (lowest pairwise L2 distance) so grouped queries share
prefetched clusters under the split budget. O(B²) distances via one
matmul + host greedy sweep — the paper measures <0.1 s at B=256; ours is
well under that on one core.

Cache-aware scheduler: assigns micro-batches to replicas ("GPUs") by
greatest overlap between the batch's predicted clusters and each
replica's resident cache, highest-overlap-first, with a load cap so
work stays balanced (and a deadline hook for straggler re-queue).
Routing additionally reads per-replica ledger occupancy and — for
multi-tenant serving — per-tenant pool occupancy, spreading a tenant's
batches away from replicas it already loads.

Wave former: under per-request continuous batching there is no static
micro-batch — at every round frontier ``SchedulerPolicy.reform_wave``
re-batches whichever requests are *ready now* into fresh tenant-pure
waves (default: EDF within priority classes, FIFO among equals,
``micro_batch``-capped), so a straggler never drags its former
batch-mates and mid-stream admits join in-flight work.

Dispatch policy: once micro-batches are queued on a replica, a
``DispatchPolicy`` orders them.  ``EdfDispatch`` (the default) runs
priority classes first and earliest-deadline-first inside a class; with
no deadlines set it degrades exactly to the legacy (priority, FIFO)
tie-break, which is what keeps the deprecated shims pinned equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Prefetching scheduler
# ---------------------------------------------------------------------------


def group_queries(embeddings: np.ndarray, micro_batch: int,
                  ) -> List[List[int]]:
    """Greedy similarity grouping. embeddings [B, d] -> list of index groups."""
    B = embeddings.shape[0]
    if B == 0:
        return []
    # pairwise squared L2 via gram matrix (one matmul)
    sq = np.sum(embeddings ** 2, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (embeddings @ embeddings.T)
    np.fill_diagonal(d2, np.inf)
    unassigned = set(range(B))
    groups: List[List[int]] = []
    while unassigned:
        seed = min(unassigned)                      # deterministic
        group = [seed]
        unassigned.remove(seed)
        while len(group) < micro_batch and unassigned:
            # nearest unassigned query to the group (min over members)
            rows = d2[np.asarray(group)][:, np.asarray(sorted(unassigned))]
            cand_sorted = np.asarray(sorted(unassigned))
            nxt = int(cand_sorted[np.argmin(np.min(rows, axis=0))])
            group.append(nxt)
            unassigned.remove(nxt)
        groups.append(group)
    return groups


def grouping_shared_cluster_gain(ranked_per_query: Sequence[Sequence[int]],
                                 groups: Sequence[Sequence[int]],
                                 top: int = 64) -> float:
    """Diagnostic: average fraction of top clusters shared within groups."""
    fracs = []
    for g in groups:
        if len(g) < 2:
            continue
        sets = [set(list(ranked_per_query[i])[:top]) for i in g]
        union = set().union(*sets)
        total = sum(len(s) for s in sets)
        fracs.append(1.0 - len(union) / max(total, 1))
    return float(np.mean(fracs)) if fracs else 0.0


# ---------------------------------------------------------------------------
# Cache-aware scheduler
# ---------------------------------------------------------------------------


@dataclass
class Assignment:
    replica: int
    batch_index: int
    overlap: int


def assign_to_replicas(batch_clusters: Sequence[Set[int]],
                       replica_caches: Sequence[Set[int]], *,
                       max_per_replica: Optional[int] = None,
                       occupancy: Optional[Sequence[float]] = None,
                       tenant_occupancy: Optional[Sequence[Sequence[float]]]
                       = None) -> List[Assignment]:
    """Greedy max-overlap assignment (paper: pick the (batch, GPU) pair with
    the greatest cached-cluster overlap, repeat in descending order).

    ``occupancy`` (per-replica HBM occupancy fractions from the memory
    ledger, in [0, 1]) breaks overlap ties toward the replica with the
    most free device memory; it is scaled well below one overlap unit so
    it can never override a real cached-cluster advantage.

    ``tenant_occupancy`` ([n_batches][n_replicas] fractions in [0, 1]:
    how much of replica r's pool batch i's *tenant* already holds)
    nudges routing away from replicas the tenant is piling onto.  Both
    soft terms combine linearly: neither can override a real
    cached-cluster advantage, and a tenant-spread difference outweighs
    a ledger-occupancy difference only when the latter is under ~0.2
    (the 2e-4 / 1e-3 weight ratio) — spreading a tenant off an
    otherwise-balanced replica is intended; overriding a clearly
    memory-loaded one is not.

    The greedy sweep masks incrementally — one O(n_b·n_r) score matrix
    for the whole assignment instead of a fresh deep copy + full re-mask
    per pick (the old loop was O(n_b²·n_r) in copies alone).
    """
    n_b, n_r = len(batch_clusters), len(replica_caches)
    if n_r == 0:
        return []
    cap = max_per_replica or -(-n_b // n_r)
    overlap = np.zeros((n_b, n_r), np.int64)
    for i, bc in enumerate(batch_clusters):
        for r, rc in enumerate(replica_caches):
            overlap[i, r] = len(bc & rc)
    occ = (np.zeros(n_r) if occupancy is None
           else np.clip(np.asarray(occupancy, np.float64), 0.0, 1.0))
    tocc = (np.zeros((n_b, n_r)) if tenant_occupancy is None
            else np.clip(np.asarray(tenant_occupancy, np.float64), 0.0, 1.0))
    load = np.zeros(n_r, np.int64)
    taken = np.zeros(n_b, bool)
    out: List[Assignment] = []
    masked = (overlap.astype(np.float64) - 1e-3 * occ[None, :]
              - 2e-4 * tocc)
    for _ in range(n_b):
        i, r = np.unravel_index(np.argmax(masked), masked.shape)
        if np.isneginf(masked[i, r]):    # everything capped — spill
            i = int(np.argmin(taken))    # first untaken, round-robin
            r = int(np.argmin(load))
        out.append(Assignment(replica=int(r), batch_index=int(i),
                              overlap=int(overlap[i, r])))
        taken[int(i)] = True
        load[int(r)] += 1
        masked[int(i), :] = -np.inf
        if load[int(r)] >= cap:
            masked[:, int(r)] = -np.inf
    out.sort(key=lambda a: a.batch_index)
    return out


# ---------------------------------------------------------------------------
# Scheduler policy: one pluggable interface over both schedulers
# ---------------------------------------------------------------------------


class SchedulerPolicy:
    """Unifies micro-batch formation (prefetching scheduler) and replica
    routing (cache-aware scheduler) behind one strategy interface, so the
    orchestrator and the RetrievalRuntime consume a single object instead
    of two free functions plus flags.

    ``needs_cluster_hints`` tells the caller whether ``assign`` wants the
    per-batch predicted cluster sets (probing them costs a ranker pass —
    skip it for routing policies that ignore cache state).
    """

    name: str = "base"
    needs_cluster_hints: bool = False

    def group(self, q_in: np.ndarray, micro_batch: int) -> List[List[int]]:
        """Partition queries (rows of ``q_in``) into micro-batches of at
        most ``micro_batch``; returns lists of row indices."""
        raise NotImplementedError

    def assign(self, batch_clusters: Sequence[Set[int]],
               replica_caches: Sequence[Set[int]], *,
               max_per_replica: Optional[int] = None,
               occupancy: Optional[Sequence[float]] = None,
               tenant_occupancy: Optional[Sequence[Sequence[float]]] = None,
               ) -> List[Assignment]:
        """Route each micro-batch (predicted cluster set) to a replica,
        reading live replica caches, ledger occupancy fractions, and —
        for multi-tenant pools — per-tenant occupancy fractions."""
        raise NotImplementedError

    def reform_wave(self, ready: Sequence, *,
                    micro_batch: Optional[int] = None,
                    now: float = 0.0) -> List[List[int]]:
        """Re-batch the *ready set* at a continuous-batching round
        frontier: partition the requests that can start a round right
        now into execution waves, returned as lists of indices into
        ``ready`` (first wave dispatches first).

        ``ready`` items expose ``tenant`` / ``priority`` /
        ``deadline_t`` (absolute event-clock seconds, ``inf`` = no
        SLO); their order is arrival order, the FIFO anchor.  The
        default is EDF/tenant-aware: order by (priority class, absolute
        deadline, arrival), then greedily fill **tenant-pure** waves of
        at most ``micro_batch`` members (``None`` = unbounded).  Every
        ready request is placed; a policy override may instead *defer*
        requests (leave them out of every wave) to wait for batch-mates
        — the runtime keeps them ready for the next frontier, and if
        the event queue would otherwise drain it forces them through
        with this base implementation (which defers nothing)."""
        if not len(ready):
            return []
        cap = micro_batch or len(ready)
        order = sorted(range(len(ready)),
                       key=lambda i: (ready[i].priority,
                                      ready[i].deadline_t, i))
        waves: List[List[int]] = []
        open_by_tenant: Dict[str, List[int]] = {}
        for i in order:
            tenant = ready[i].tenant
            wave = open_by_tenant.get(tenant)
            if wave is None or len(wave) >= cap:
                wave = []
                waves.append(wave)
                open_by_tenant[tenant] = wave
            wave.append(i)
        return waves


def _fifo_groups(n: int, micro_batch: int) -> List[List[int]]:
    return [list(range(i, min(i + micro_batch, n)))
            for i in range(0, n, micro_batch)]


@dataclass
class TeleRAGScheduler(SchedulerPolicy):
    """The paper's pair (Fig. 7): similarity grouping + cache-aware
    routing.  Either half degrades to the naive behaviour via its flag,
    covering all four ablation cells of §5.4 with one class."""

    similarity_grouping: bool = True
    cache_aware: bool = True
    name = "telerag"

    @property
    def needs_cluster_hints(self) -> bool:          # type: ignore[override]
        return self.cache_aware

    def group(self, q_in: np.ndarray, micro_batch: int) -> List[List[int]]:
        """Similarity grouping (or FIFO when the flag is off)."""
        if self.similarity_grouping:
            return group_queries(q_in, micro_batch)
        return _fifo_groups(q_in.shape[0], micro_batch)

    def assign(self, batch_clusters, replica_caches, *,
               max_per_replica=None, occupancy=None,
               tenant_occupancy=None) -> List[Assignment]:
        """Cache-aware greedy routing (or round-robin when the flag is
        off); see ``assign_to_replicas`` for the tie-break ordering."""
        if self.cache_aware:
            return assign_to_replicas(batch_clusters, replica_caches,
                                      max_per_replica=max_per_replica,
                                      occupancy=occupancy,
                                      tenant_occupancy=tenant_occupancy)
        n_r = len(replica_caches)
        return [Assignment(replica=i % n_r, batch_index=i, overlap=0)
                for i in range(len(batch_clusters))]


class RoundRobinScheduler(TeleRAGScheduler):
    """FIFO micro-batches, round-robin routing (the no-scheduler baseline)."""

    name = "round_robin"

    def __init__(self):
        super().__init__(similarity_grouping=False, cache_aware=False)


# ---------------------------------------------------------------------------
# Dispatch policy: ordering queued micro-batches within a replica
# ---------------------------------------------------------------------------


class DispatchPolicy:
    """Orders a replica's *queued* micro-batches: when the replica
    runtime drains, the server dispatches the batch with the smallest
    ``key``.  Keys are compared lexicographically; ``deadline_t`` is an
    absolute event-clock deadline in seconds (``inf`` = no SLO) and
    ``order`` is the batch's global enqueue sequence (the FIFO anchor
    that makes every policy total and deterministic)."""

    name: str = "base"

    def key(self, *, priority: int, deadline_t: float, order: int,
            now: float) -> Tuple:
        """Sort key for one queued batch at clock time ``now``
        (seconds); the smallest key dispatches first."""
        raise NotImplementedError


class FifoDispatch(DispatchPolicy):
    """Strict arrival order — ignores priorities and deadlines (the
    SLO-blind baseline ``bench_tenants.py`` compares against)."""

    name = "fifo"

    def key(self, *, priority: int, deadline_t: float, order: int,
            now: float) -> Tuple:
        """(order,): pure FIFO."""
        return (order,)


class EdfDispatch(DispatchPolicy):
    """Priority classes first, earliest-deadline-first within a class,
    FIFO among equals.  With no deadlines set (every ``deadline_t`` is
    ``inf``) this is exactly the legacy (priority, order) tie-break, so
    single-tenant callers see unchanged dispatch order."""

    name = "edf"

    def key(self, *, priority: int, deadline_t: float, order: int,
            now: float) -> Tuple:
        """(priority class, absolute deadline, enqueue order)."""
        return (priority, deadline_t, order)


# ---------------------------------------------------------------------------
# Straggler mitigation / elastic hooks (used by the engine + tests)
# ---------------------------------------------------------------------------


@dataclass
class ReplicaHealth:
    deadline_s: float = 5.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def heartbeat(self, replica: int, now: float) -> None:
        self.last_seen[replica] = now

    def healthy(self, replicas: Sequence[int], now: float) -> List[int]:
        return [r for r in replicas
                if now - self.last_seen.get(r, now) < self.deadline_s]

    def requeue_straggler_batches(self, assignments: List[Assignment],
                                  dead: Set[int]) -> Tuple[List[Assignment],
                                                           List[int]]:
        """Drop assignments on dead replicas; return surviving + re-queue."""
        alive = [a for a in assignments if a.replica not in dead]
        requeue = [a.batch_index for a in assignments if a.replica in dead]
        return alive, requeue
