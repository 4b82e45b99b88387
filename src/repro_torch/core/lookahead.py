"""Lookahead retrieval planning (paper §4.1, §4.2, §4.3).

Given the clusters ranked by q_in (the *pre*-rewrite query), choose which
whole clusters to prefetch under a byte budget:

  * whole-cluster granularity with the skip-if-over-budget rule (§4.3):
    "the system fills this budget by adding whole clusters sequentially
    based on query proximity; if the next closest cluster exceeds the
    remaining budget, it is skipped entirely";
  * already-resident clusters (cache hits / earlier rounds) cost nothing
    (§4.3 multi-round incremental prefetch);
  * batched mode splits the total budget equally among the queries of a
    micro-batch (§4.2) — clusters shared between queries are charged once,
    which is exactly what the prefetching scheduler maximizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.datastore import PagedClusters


@dataclass
class PrefetchPlan:
    fetch: List[int]                 # clusters to transfer now (rank order)
    resident_hits: List[int]         # ranked clusters already on device
    skipped: List[int]               # skipped whole clusters (budget rule)
    bytes_planned: int = 0
    pages_planned: int = 0
    ranked: Optional[Sequence] = None  # the ranking it was planned from, so
                                       # a capped replan can skip the probe

    @property
    def covered(self) -> Set[int]:
        return set(self.fetch) | set(self.resident_hits)


def plan_prefetch(ranked: Sequence[int], paged: PagedClusters, *,
                  budget_bytes: int, resident: Set[int],
                  free_pages: int) -> PrefetchPlan:
    """Single-query lookahead plan over clusters ranked by q_in proximity."""
    plan = PrefetchPlan([], [], [])
    remaining = budget_bytes
    pages_left = free_pages
    for c in ranked:
        c = int(c)
        if c in resident:
            plan.resident_hits.append(c)
            continue
        nb = paged.cluster_bytes(c)
        npg = int(paged.cluster_num_pages[c])
        if nb <= remaining and npg <= pages_left:
            plan.fetch.append(c)
            remaining -= nb
            pages_left -= npg
            plan.bytes_planned += nb
            plan.pages_planned += npg
        else:
            plan.skipped.append(c)
    return plan


def plan_batched_prefetch(ranked_per_query: Sequence[Sequence[int]],
                          paged: PagedClusters, *,
                          budget_bytes: int, resident: Set[int],
                          free_pages: int) -> Tuple[PrefetchPlan, np.ndarray]:
    """Micro-batch plan: equal per-query budget split (§4.2).

    Walks queries round-robin in rank order. A cluster chosen by an earlier
    query (or resident) is free for later ones — shared interest costs one
    transfer. Returns (plan, per_query_covered_count).
    """
    B = len(ranked_per_query)
    per_budget = np.full(B, budget_bytes / max(B, 1))
    plan = PrefetchPlan([], [], [])
    chosen: Set[int] = set()
    skipped_seen: Set[int] = set()
    pages_left = free_pages
    covered_count = np.zeros(B, np.int64)
    iters = [list(map(int, r)) for r in ranked_per_query]
    maxlen = max((len(r) for r in iters), default=0)
    for rank in range(maxlen):
        for qi in range(B):
            if rank >= len(iters[qi]):
                continue
            c = iters[qi][rank]
            if c in resident:
                if c not in plan.resident_hits:
                    plan.resident_hits.append(c)
                covered_count[qi] += 1
                continue
            if c in chosen:
                covered_count[qi] += 1
                continue
            nb = paged.cluster_bytes(c)
            npg = int(paged.cluster_num_pages[c])
            if nb <= per_budget[qi] and npg <= pages_left:
                plan.fetch.append(c)
                chosen.add(c)
                if c in skipped_seen:     # another query could afford it
                    skipped_seen.discard(c)
                    plan.skipped.remove(c)
                per_budget[qi] -= nb
                pages_left -= npg
                plan.bytes_planned += nb
                plan.pages_planned += npg
                covered_count[qi] += 1
            elif c not in skipped_seen:
                # report each skipped cluster once, not once per query
                skipped_seen.add(c)
                plan.skipped.append(c)
    return plan, covered_count


@dataclass
class RoundState:
    """Multi-round bookkeeping (§4.3): full prefetch in round one, then
    incremental top-ups of only the missing clusters."""

    fetched: Set[int] = field(default_factory=set)
    round: int = 0

    def incremental_plan(self, ranked: Sequence[int], paged: PagedClusters, *,
                         budget_bytes: int, resident: Set[int],
                         free_pages: int) -> PrefetchPlan:
        eff_resident = resident | self.fetched
        plan = plan_prefetch(ranked, paged, budget_bytes=budget_bytes,
                             resident=eff_resident, free_pages=free_pages)
        self.fetched |= set(plan.fetch)
        self.round += 1
        return plan
