"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and JSONL.

The Perfetto export lays one *process* per replica (pid = replica
index; the server's own events land on a synthetic "server" process)
with one *thread track per lane*:

  tid 1  decode      — ``generate`` / ``generate_tail`` spans
  tid 2  link        — H2D transfers (issue->land) + ``transfer_wait``
  tid 3  retrieval   — ``retrieve`` spans (+ zero-length dispatches)
  tid 4  admission   — ``pressure_stall`` spans, admission instants

Requests are **async spans** (``ph: b``/``e``, cat ``request``, id =
request id) from admit to complete, so Perfetto draws each request's
life as one arrow-connected track regardless of which lane its rounds
ran on.  Counter tracks (``ph: C``) are derived from the recorder
stream: ``ledger_occupancy`` and ``pool_free_pages`` from pool
lease/release edges, ``kv_bytes`` per tenant from KV-category pool
edges, ``queue_depth`` from server samples.

Timestamps: the event clock is seconds; Chrome wants microseconds
(``ts`` / ``dur``).  Load the file at https://ui.perfetto.dev or
chrome://tracing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.obs.recorder import FlightRecorder, TraceEvent

_US = 1e6
_SERVER_PID = 9999                    # replica=-1 events (server lane)

_LANES = {"decode": 1, "link": 2, "retrieval": 3, "admission": 4}
_SPAN_LANE = {
    "generate": "decode", "generate_tail": "decode",
    "transfer_wait": "link",
    "retrieve": "retrieval", "prefetch_dispatch": "retrieval",
    "pressure_stall": "admission",
}


def _pid(ev: TraceEvent) -> int:
    return ev.replica if ev.replica >= 0 else _SERVER_PID


def to_perfetto(rec: FlightRecorder) -> Dict[str, object]:
    """Render the recorder into a Chrome ``trace_event`` document."""
    out: List[Dict[str, object]] = []
    pids = sorted({_pid(e) for e in rec.events} | {_SERVER_PID})
    for pid in pids:
        name = "server" if pid == _SERVER_PID else f"replica {pid}"
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name}})
        for lane, tid in _LANES.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": lane}})

    # running per-(pid, tenant) KV bytes, rebuilt from pool edges
    kv_bytes: Dict[int, Dict[str, float]] = {}
    for ev in rec.sorted_events():
        pid = _pid(ev)
        ts = ev.t * _US
        if ev.kind == "span":
            lane = _SPAN_LANE.get(ev.name)
            if lane is None:          # admit/complete instants ride the
                continue              # async request span instead
            out.append({"ph": "X", "name": ev.name, "pid": pid,
                        "tid": _LANES[lane], "ts": ts,
                        "dur": max(0.0, ev.dur) * _US, "cat": "span",
                        "args": {"request_id": ev.request_id,
                                 "round": ev.round_index,
                                 "wave_id": ev.wave_id,
                                 "tenant": ev.tenant}})
        elif ev.kind == "request":
            if ev.label == "admit":
                out.append({"ph": "b", "cat": "request",
                            "id": ev.request_id,
                            "name": f"req {ev.request_id}", "pid": pid,
                            "tid": _LANES["decode"], "ts": ts,
                            "args": {"tenant": ev.tenant}})
            elif ev.label == "complete":
                out.append({"ph": "e", "cat": "request",
                            "id": ev.request_id,
                            "name": f"req {ev.request_id}", "pid": pid,
                            "tid": _LANES["decode"], "ts": ts})
            elif ev.label in ("pressure_stall", "pressure_resume",
                              "prefetch_demoted", "submit"):
                out.append({"ph": "i", "name": ev.label, "pid": pid,
                            "tid": _LANES["admission"], "ts": ts,
                            "s": "t",
                            "args": {"request_id": ev.request_id}})
        elif ev.kind == "transfer.issue":
            out.append({"ph": "X", "name": f"h2d {ev.transfer_kind}",
                        "pid": pid, "tid": _LANES["link"],
                        "ts": ev.start_t * _US,
                        "dur": max(0.0, ev.end_t - ev.start_t) * _US,
                        "cat": "transfer",
                        "args": {"transfer_id": ev.transfer_id,
                                 "nbytes": ev.nbytes,
                                 "clusters": ev.n_clusters,
                                 "channel": ev.channel,
                                 "queued_us": (ev.start_t - ev.t) * _US}})
        elif ev.kind in ("pool.lease", "pool.release"):
            out.append({"ph": "C", "name": "pool_free_pages", "pid": pid,
                        "ts": ts, "args": {"free": ev.free_pages}})
            out.append({"ph": "C", "name": "ledger_occupancy", "pid": pid,
                        "ts": ts, "args": {"occupancy": ev.occupancy}})
            if ev.owner == "kv":
                per = kv_bytes.setdefault(pid, {})
                delta = ev.nbytes if ev.kind == "pool.lease" else -ev.nbytes
                per[ev.tenant] = per.get(ev.tenant, 0.0) + delta
                out.append({"ph": "C", "name": "kv_bytes", "pid": pid,
                            "ts": ts, "args": dict(per)})
        elif ev.kind == "counter":
            out.append({"ph": "C", "name": ev.name, "pid": pid, "ts": ts,
                        "args": {"value": ev.value}})
        elif ev.kind.startswith("wave."):
            # transfer_id / request_ids make the instant replayable by
            # the reference package's happens-before checker
            # (repro.analysis.invariants)
            out.append({"ph": "i", "name": ev.kind, "pid": pid,
                        "tid": _LANES["retrieval"], "ts": ts, "s": "t",
                        "args": {"wave_id": ev.wave_id, "size": ev.size,
                                 "transfer_id": ev.transfer_id,
                                 "nbytes": ev.nbytes,
                                 "request_ids": list(ev.request_ids)}})
        elif ev.kind.startswith("admission."):
            out.append({"ph": "i", "name": ev.kind, "pid": pid,
                        "tid": _LANES["admission"], "ts": ts, "s": "t",
                        "args": {"owner": ev.owner,
                                 "wave_id": ev.wave_id,
                                 "pages_requested": ev.pages_requested,
                                 "pages_granted": ev.pages_granted}})
        elif ev.kind == "decode":
            out.append({"ph": "i", "name": "decode_step", "pid": pid,
                        "tid": _LANES["decode"], "ts": ts, "s": "t",
                        "args": {"request_id": ev.request_id,
                                 "tokens": ev.tokens,
                                 "seconds": ev.seconds,
                                 "batch": ev.batch}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"schema": "telerag.trace/v1",
                          "dropped_events": rec.dropped}}


def write_trace(rec: FlightRecorder, path: str) -> str:
    """Write the Perfetto JSON document to ``path``; returns it."""
    with open(path, "w") as f:
        json.dump(to_perfetto(rec), f)
    return path


def to_jsonl(rec: FlightRecorder) -> List[str]:
    """One JSON object per raw event (typed: ``event`` holds the
    dataclass name), in emission order — the lossless stream form."""
    lines = []
    for ev in rec.events:
        d = dataclasses.asdict(ev)
        d["event"] = type(ev).__name__
        lines.append(json.dumps(d))
    return lines


def write_jsonl(rec: FlightRecorder, path: str) -> str:
    """Write the JSONL stream to ``path``; returns it."""
    with open(path, "w") as f:
        for line in to_jsonl(rec):
            f.write(line + "\n")
    return path


def load_jsonl(path: str) -> List[Dict[str, object]]:
    """Parse a JSONL stream back into plain dicts (analysis tooling)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
