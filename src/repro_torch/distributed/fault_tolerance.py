"""Cluster fault tolerance: heartbeats, stragglers, elastic re-slicing (the
reference's ``distributed/fault_tolerance.py``, the port's own copy).

What runs here vs. at scale:
  * heartbeats / straggler deadlines — real logic, tested by simulation;
  * elastic re-slicing — deterministic recomputation of the data-axis
    layout when the replica set changes: every surviving replica derives
    the identical new assignment with no coordinator round-trip (the
    re-slice is a pure function of (step, healthy_set));
  * training restart — checkpoint restore (training/checkpoint.py) plus
    TokenStream cursor; serving restart — engine.snapshot()/restore().

No torch here: the logic is host bookkeeping, the same on any backend.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass
class HeartbeatMonitor:
    deadline_s: float = 10.0
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, node: int, now: Optional[float] = None) -> None:
        self._last[node] = time.monotonic() if now is None else now

    def dead(self, nodes: Sequence[int], now: Optional[float] = None,
             ) -> Set[int]:
        now = time.monotonic() if now is None else now
        return {n for n in nodes
                if now - self._last.get(n, -1e18) > self.deadline_s}


@dataclass
class StragglerPolicy:
    """Deadline = factor × median completion time of the batch's peers."""
    factor: float = 3.0
    min_deadline_s: float = 1.0

    def stragglers(self, durations: Dict[int, Optional[float]],
                   now_elapsed: float) -> Set[int]:
        done = [d for d in durations.values() if d is not None]
        if not done:
            return set()
        med = sorted(done)[len(done) // 2]
        deadline = max(self.factor * med, self.min_deadline_s)
        return {n for n, d in durations.items()
                if d is None and now_elapsed > deadline}


def elastic_slices(step: int, healthy: Sequence[int], global_batch: int,
                   ) -> Dict[int, Tuple[int, int]]:
    """Deterministic contiguous batch slices for the healthy replica set.

    Remainders go to the lowest-ranked replicas so every node computes the
    same layout independently. Returns {replica: (start, stop)}.
    """
    nodes = sorted(healthy)
    n = len(nodes)
    if n == 0:
        return {}
    base = global_batch // n
    rem = global_batch % n
    out: Dict[int, Tuple[int, int]] = {}
    start = 0
    for i, node in enumerate(nodes):
        size = base + (1 if i < rem else 0)
        out[node] = (start, start + size)
        start += size
    assert start == global_batch
    return out


@dataclass
class ElasticRun:
    """Tracks replica membership across steps; yields re-slice events."""
    global_batch: int
    members: Set[int] = field(default_factory=set)
    history: List[Tuple[int, Tuple[int, ...]]] = field(default_factory=list)

    def resize(self, step: int, healthy: Set[int],
               ) -> Dict[int, Tuple[int, int]]:
        if healthy != self.members:
            self.members = set(healthy)
            self.history.append((step, tuple(sorted(healthy))))
        return elastic_slices(step, sorted(self.members), self.global_batch)
