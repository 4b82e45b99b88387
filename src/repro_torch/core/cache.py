"""Decay-based cluster hotness cache (paper Appendix D, Eq. 6).

Every resident cluster carries a hotness value:
    h_{r+1} = h_r / d            if unused in round r
    h_{r+1} = h_r / d + h_inc    if used in round r
New fetches start at h_init. After each served batch the cache is
consolidated: only the hottest clusters are retained, up to
``fraction * buffer_pages`` (paper default fraction = 0.5); everything
else is evicted so the next round's prefetch has deterministic headroom —
this mirrors the paper's "evict excessive clusters and consolidate after
serving each batch" reproducibility rule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.prefetch_buffer import PrefetchBuffer


@dataclass
class CacheConfig:
    fraction: float = 0.5
    h_init: float = 1.0
    h_inc: float = 1.0
    decay: float = 2.0


class ClusterCache:
    def __init__(self, cfg: CacheConfig = CacheConfig()):
        self.cfg = cfg
        self.hotness: Dict[int, float] = {}
        self.hits = 0
        self.misses = 0

    # -- round lifecycle -----------------------------------------------------
    def on_fetched(self, clusters: Iterable[int]) -> None:
        for c in clusters:
            self.hotness.setdefault(int(c), self.cfg.h_init)

    def round_update(self, used_clusters: Iterable[int]) -> None:
        """Apply Eq. 6 across all tracked clusters."""
        used = set(int(c) for c in used_clusters)
        for c in list(self.hotness):
            h = self.hotness[c] / self.cfg.decay
            if c in used:
                h += self.cfg.h_inc
            self.hotness[c] = h

    def record_lookup(self, needed: Sequence[int], resident: Set[int]) -> None:
        for c in needed:
            if int(c) in resident:
                self.hits += 1
            else:
                self.misses += 1

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    # -- consolidation ---------------------------------------------------------
    def quota_pages(self, buffer: PrefetchBuffer) -> int:
        # keyed to the prefetch quota, not the pool extent: a pool also
        # hosting KV leases must not inflate cache retention
        return int(self.cfg.fraction * buffer.quota_pages)

    def consolidate(self, buffer: PrefetchBuffer) -> List[int]:
        """Keep the hottest clusters within the cache quota; evict the rest.

        Returns the evicted cluster list. Applied after each served batch.
        """
        quota = self.quota_pages(buffer)
        # rank resident clusters by hotness (desc), keep while quota lasts
        resident = [(c, self.hotness.get(c, 0.0)) for c in buffer.resident]
        resident.sort(key=lambda t: -t[1])
        keep: Set[int] = set()
        used = 0
        for c, _ in resident:
            npg = int(buffer.paged.cluster_num_pages[c])
            if used + npg <= quota:
                keep.add(c)
                used += npg
        evict = [c for c in buffer.resident if c not in keep]
        buffer.evict_clusters(evict, force=True)
        # hotness keys ⊆ resident ∪ just-fetched is an invariant (every key
        # enters via on_fetched and leaves with its eviction), so popping
        # the evicted set is the whole cleanup — no second full scan
        for c in evict:
            self.hotness.pop(c, None)
        return evict

    def make_room(self, buffer: PrefetchBuffer, pages_needed: int, *,
                  protect: Optional[Set[int]] = None) -> List[int]:
        """Evict coldest *unpinned* clusters until >= pages_needed slots
        are free (clusters pinned by an in-flight wave are untouchable —
        this is the admission controller's spill hook).  ``protect``
        additionally shields named clusters: the controller passes
        enough of each other tenant's residency to keep it at its
        guaranteed floor, so one tenant's spill can never dig another
        below its reservation."""
        if buffer.free_pages() >= pages_needed:
            return []
        pinned = buffer.pinned_clusters()
        if protect:
            pinned = pinned | {int(c) for c in protect}
        order = sorted((c for c in buffer.resident if c not in pinned),
                       key=lambda c: self.hotness.get(c, 0.0))
        evicted: List[int] = []
        for c in order:
            if buffer.free_pages() >= pages_needed:
                break
            buffer.evict_clusters([c])
            self.hotness.pop(c, None)
            evicted.append(c)
        return evicted
