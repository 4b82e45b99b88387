"""Post-hoc overlap analysis over a recorded trace.

TeleRAG's efficiency claim is that the lookahead H2D copy hides under
the LLM's pre-retrieval generation window.  This module turns a
``FlightRecorder`` stream into the paper's key numbers:

* **Per-round lookahead overlap ratio** — each retrieving wave member
  models its copy of the wave's transfer from its own round start
  (``dispatch + duration``, the per-request link view of App. C); the
  ratio is the fraction of that copy interval hidden under the
  member's generation span.  1.0 = fully hidden (the TeleRAG ideal),
  0.0 = fully exposed (the sequential baseline).
* **Stall-time attribution** — where non-overlapped time went:
  ``link_s`` (``transfer_wait`` spans: generation ended before the
  copy landed), ``pressure_s`` (``pressure_stall`` spans: parked on
  pool admission), ``queue_s`` (server submit -> replica admit).
* **Wave-fragmentation stats** — dispatched wave sizes (mean,
  singleton fraction): how much batch efficiency the dynamic former
  is recovering or losing.

Pure function of the recorder — no live serving state is touched, so
it runs equally on a just-drained server or a trace re-loaded later.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs.recorder import FlightRecorder


@dataclass(frozen=True)
class OverlapRound:
    """One retrieving member-round's overlap accounting (seconds)."""

    request_id: int
    replica: int
    wave_id: int
    round_index: int
    transfer_s: float                 # the member's modeled copy length
    hidden_s: float                   # |copy interval ∩ generate span|
    wait_s: float                     # transfer_wait after generation

    @property
    def ratio(self) -> float:
        """Fraction of the copy hidden under generation (0 when the
        round moved nothing)."""
        return self.hidden_s / self.transfer_s if self.transfer_s > 0 else 0.0


@dataclass(frozen=True)
class OverlapReport:
    """The analyzer's output: per-round rows plus the aggregates the
    serve drivers print and benches assert on."""

    rounds: List[OverlapRound] = field(default_factory=list)
    stall: Dict[str, float] = field(default_factory=dict)
    wave_sizes: List[int] = field(default_factory=list)
    n_requests: int = 0

    @property
    def prefetched_rounds(self) -> List[OverlapRound]:
        """Rounds that actually moved bytes (demoted/all-hit rounds
        have no copy to hide and are excluded from ratio means)."""
        return [r for r in self.rounds if r.transfer_s > 0]

    @property
    def mean_overlap_ratio(self) -> float:
        pre = self.prefetched_rounds
        return float(np.mean([r.ratio for r in pre])) if pre else 0.0

    @property
    def fully_hidden_frac(self) -> float:
        """Fraction of prefetched rounds whose copy hid entirely."""
        pre = self.prefetched_rounds
        if not pre:
            return 0.0
        return float(np.mean([r.ratio >= 1.0 - 1e-9 for r in pre]))

    @property
    def mean_wave_size(self) -> float:
        return float(np.mean(self.wave_sizes)) if self.wave_sizes else 0.0

    @property
    def singleton_wave_frac(self) -> float:
        if not self.wave_sizes:
            return 0.0
        return float(np.mean([s == 1 for s in self.wave_sizes]))

    def summary(self) -> str:
        """Printable block (what ``launch/serve.py`` appends)."""
        st = self.stall
        return "\n".join([
            f"overlap: {len(self.prefetched_rounds)} prefetched rounds "
            f"(of {len(self.rounds)}), mean hidden "
            f"{self.mean_overlap_ratio:.1%}, fully hidden "
            f"{self.fully_hidden_frac:.1%}",
            f"stalls: link={st.get('link_s', 0.0)*1e3:.1f}ms "
            f"pressure={st.get('pressure_s', 0.0)*1e3:.1f}ms "
            f"queue={st.get('queue_s', 0.0)*1e3:.1f}ms",
            f"waves: {len(self.wave_sizes)} dispatched, mean size "
            f"{self.mean_wave_size:.2f}, singletons "
            f"{self.singleton_wave_frac:.1%}",
        ])


def _intersect(a0: float, a1: float, b0: float, b1: float) -> float:
    """Length of [a0,a1] ∩ [b0,b1] (0 when disjoint)."""
    return max(0.0, min(a1, b1) - max(a0, b0))


def analyze(rec: FlightRecorder) -> OverlapReport:
    """Compute the overlap report from a recorded trace."""
    # wave dispatch -> its lookahead transfer correlation
    wave_transfer: Dict[Tuple[int, int], int] = {}
    wave_sizes: List[int] = []
    for ev in rec.of("wave.dispatch"):
        wave_sizes.append(ev.size)
        if ev.transfer_id >= 0:
            wave_transfer[(ev.replica, ev.wave_id)] = ev.transfer_id
    transfers = {(ev.replica, ev.transfer_id): ev
                 for ev in rec.of("transfer.issue")}

    # per-member spans, keyed (replica, request, round)
    gen: Dict[Tuple[int, int, int], Tuple[float, float, int]] = {}
    wait: Dict[Tuple[int, int, int], float] = {}
    pressure_s = 0.0
    for ev in rec.of("span"):
        key = (ev.replica, ev.request_id, ev.round_index)
        if ev.name == "generate":
            gen[key] = (ev.t, ev.t + ev.dur, ev.wave_id)
        elif ev.name == "transfer_wait":
            wait[key] = wait.get(key, 0.0) + ev.dur
        elif ev.name == "pressure_stall":
            pressure_s += ev.dur

    rounds: List[OverlapRound] = []
    for (replica, rid, rnd), (g0, g1, wid) in sorted(gen.items()):
        tid = wave_transfer.get((replica, wid), -1)
        tr = transfers.get((replica, tid))
        dur = (tr.end_t - tr.start_t) if tr is not None else 0.0
        # per-request link view: the member models the copy from its own
        # round start (== its generate start; lookahead dispatches at the
        # frontier) for the transfer's duration
        hidden = _intersect(g0, g0 + dur, g0, g1) if dur > 0 else 0.0
        rounds.append(OverlapRound(
            request_id=rid, replica=replica, wave_id=wid, round_index=rnd,
            transfer_s=dur, hidden_s=hidden,
            wait_s=wait.get((replica, rid, rnd), 0.0)))

    # queue attribution: server-side submit -> replica admit, per request
    submit_t: Dict[int, float] = {}
    admit_t: Dict[int, float] = {}
    complete = 0
    for ev in rec.of("request"):
        if ev.label == "submit" and ev.request_id not in submit_t:
            submit_t[ev.request_id] = ev.t
        elif ev.label == "admit" and ev.request_id not in admit_t:
            admit_t[ev.request_id] = ev.t
        elif ev.label == "complete":
            complete += 1
    queue_s = sum(max(0.0, admit_t[r] - t) for r, t in submit_t.items()
                  if r in admit_t)

    return OverlapReport(
        rounds=rounds,
        stall={"link_s": sum(w for w in wait.values()),
               "pressure_s": pressure_s, "queue_s": queue_s},
        wave_sizes=wave_sizes,
        n_requests=len(admit_t))
