"""Happens-before invariant checker over a ``FlightRecorder`` stream:
the reference's ``analysis/invariants.py``, for the port's recorder.

Replays the typed event stream (live ``TraceEvent`` objects, or plain
dicts loaded from the lossless JSONL export) and verifies the partial
orders TeleRAG's overlap correctness rides on:

  * **transfer issue → land → use**: a wave's ``retrieve`` span must
    not start before its correlated transfer's modeled landing — a
    violation is exactly the use-before-land race lookahead retrieval
    exists to avoid (pages searched before the H2D copy finished).
  * **admission admit → dispatch**: a wave that moved prefetch bytes
    (``wave.dispatch`` with a transfer id) must have a prior admission
    decision for the same (replica, wave) — reservations are taken
    before pages move, never retroactively.
  * **lease → release conservation**: per (replica, owner category)
    the outstanding page/byte balance from ``pool.lease`` /
    ``pool.release`` edges never goes negative (double release /
    over-release) and — in drained mode — ends at zero for the owner
    categories the caller says must drain.
  * **kv acquire → decode → release**: decode steps only appear after
    a KV acquire on that replica (when the replica uses managed KV at
    all), and KV acquire/release edges balance.
  * **paged lease discipline**: events carrying a ``lease_id`` (the
    block-table decode path) obey per-(replica, lease) ordering —
    ``kv.append`` only between that lease's ``kv.acquire`` and
    ``kv.release``, never past the lease's ``max_len`` capacity — and
    page conservation: the slab page count returned at ``kv.release``
    equals the count taken at ``kv.acquire``, and a lease id is never
    opened twice (ids are process-global and unique by construction).
  * **stall → resume**: in drained mode no request may end its life
    parked (``pressure_stall`` as its last lifecycle mark), and every
    ``admission.stall`` needs a matching resume.

The checker is a pure function of the event stream: no engine state,
no clocks — so it runs identically on a live recorder (``chip_smoke.py``
after each serve), on a JSONL file (``python -m repro_torch.analysis
--trace``), or on a Perfetto export's partial reconstruction
(``events_from_perfetto`` — span/transfer/admission subset only; pool
conservation needs the JSONL stream, whose events keep owner/pages).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, is_dataclass, asdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

EPS = 1e-9

# violation kinds (docs/ANALYSIS.md glossary)
USE_BEFORE_LAND = "use_before_land"
DISPATCH_WITHOUT_ADMISSION = "dispatch_without_admission"
DOUBLE_RELEASE = "double_release"
LEDGER_DRIFT = "ledger_drift"
KV_DOUBLE_RELEASE = "kv_double_release"
KV_LEASE_REUSE = "kv_lease_reuse"
KV_APPEND_OUT_OF_LEASE = "kv_append_out_of_lease"
KV_APPEND_OVERFLOW = "kv_append_overflow"
KV_PAGE_CONSERVATION = "kv_page_conservation"
KV_SPLICE_OUT_OF_LEASE = "kv_splice_out_of_lease"
KV_RECYCLE_MISMATCH = "kv_recycle_mismatch"
CHUNK_PIN_BEFORE_LOAD = "chunk_pin_before_load"
CHUNK_UNPIN_WITHOUT_PIN = "chunk_unpin_without_pin"
CHUNK_EVICT_WHILE_PINNED = "chunk_evict_while_pinned"
CHUNK_PAGE_CONSERVATION = "chunk_page_conservation"
DECODE_WITHOUT_KV = "decode_without_kv"
TRANSFER_INVERTED = "transfer_inverted"
LIFECYCLE_DISORDER = "lifecycle_disorder"
STALL_WITHOUT_RESUME = "stall_without_resume"
HELD_AT_DRAIN = "held_at_drain"


@dataclass(frozen=True)
class InvariantViolation:
    kind: str
    message: str
    t: float = 0.0
    replica: int = -1
    request_id: int = -1
    wave_id: int = -1

    def render(self) -> str:
        where = f"replica {self.replica}" if self.replica >= 0 else "server"
        ids = "".join(
            f" {k}={v}" for k, v in (("req", self.request_id),
                                     ("wave", self.wave_id)) if v >= 0)
        return f"[{self.kind}] t={self.t:.6f} {where}{ids}: {self.message}"


@dataclass
class InvariantReport:
    violations: List[InvariantViolation] = field(default_factory=list)
    checked_events: int = 0
    stats: Dict[str, int] = field(default_factory=dict)
    # leftover balances at end of stream (informational unless the
    # owner category was passed in ``must_drain``)
    outstanding: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def of(self, kind: str) -> List[InvariantViolation]:
        return [v for v in self.violations if v.kind == kind]

    def summary(self) -> str:
        head = (f"invariants: {self.checked_events} events, "
                f"{len(self.violations)} violation(s)")
        if not self.violations:
            return head + " — OK"
        by_kind: Dict[str, int] = {}
        for v in self.violations:
            by_kind[v.kind] = by_kind.get(v.kind, 0) + 1
        lines = [head]
        lines += [f"  {k}: {n}" for k, n in sorted(by_kind.items())]
        lines += ["  " + v.render() for v in self.violations[:20]]
        if len(self.violations) > 20:
            lines.append(f"  ... {len(self.violations) - 20} more")
        return "\n".join(lines)


# -- event normalization -----------------------------------------------------


def _norm(ev) -> Dict[str, object]:
    """TraceEvent dataclass or dict -> plain dict with a ``kind`` key."""
    if isinstance(ev, dict):
        return ev
    if is_dataclass(ev):
        return asdict(ev)
    raise TypeError(f"not a trace event: {ev!r}")


def events_from_jsonl(path: str) -> List[Dict[str, object]]:
    """Load the lossless JSONL stream
    (``repro_torch.obs.export.write_jsonl``) back into plain event
    dicts, emission order preserved."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def events_from_perfetto(doc: Dict) -> List[Dict[str, object]]:
    """Partial reconstruction from a Perfetto export: ``retrieve``
    spans, transfers, wave/admission instants and request marks — the
    subset needed for the race/ordering checks.  Pool conservation
    checks need the JSONL stream (the Perfetto export collapses pool
    edges into counter tracks)."""
    out: List[Dict[str, object]] = []
    us = 1e-6

    def replica(ev) -> int:
        pid = ev.get("pid", -1)
        return -1 if pid == 9999 else int(pid)

    for ev in doc.get("traceEvents", []):
        ph, name = ev.get("ph"), ev.get("name", "")
        args = ev.get("args", {}) or {}
        t = float(ev.get("ts", 0.0)) * us
        if ph == "X" and ev.get("cat") == "span":
            out.append({"kind": "span", "name": name, "t": t,
                        "dur": float(ev.get("dur", 0.0)) * us,
                        "replica": replica(ev),
                        "request_id": int(args.get("request_id", -1)),
                        "wave_id": int(args.get("wave_id", -1)),
                        "round_index": int(args.get("round", -1)),
                        "tenant": args.get("tenant", "shared")})
        elif ph == "X" and ev.get("cat") == "transfer":
            start = t
            end = start + float(ev.get("dur", 0.0)) * us
            issue_t = start - float(args.get("queued_us", 0.0)) * us
            base = {"replica": replica(ev),
                    "transfer_id": int(args.get("transfer_id", -1)),
                    "nbytes": int(args.get("nbytes", 0)),
                    "n_clusters": int(args.get("clusters", 0)),
                    "channel": int(args.get("channel", -1)),
                    "start_t": start, "end_t": end}
            out.append(dict(base, kind="transfer.issue", t=issue_t))
            out.append(dict(base, kind="transfer.land", t=end))
        elif ph == "i" and name.startswith("wave."):
            out.append({"kind": name, "t": t, "replica": replica(ev),
                        "wave_id": int(args.get("wave_id", -1)),
                        "size": int(args.get("size", 0)),
                        "transfer_id": int(args.get("transfer_id", -1)),
                        "nbytes": int(args.get("nbytes", 0)),
                        "request_ids": tuple(args.get("request_ids", ()))})
        elif ph == "i" and name.startswith("admission."):
            out.append({"kind": name, "t": t, "replica": replica(ev),
                        "wave_id": int(args.get("wave_id", -1)),
                        "owner": args.get("owner", ""),
                        "pages_requested": int(args.get("pages_requested", 0)),
                        "pages_granted": int(args.get("pages_granted", 0))})
        elif ph == "b" and ev.get("cat") == "request":
            out.append({"kind": "request", "label": "admit", "t": t,
                        "replica": replica(ev),
                        "request_id": int(ev.get("id", -1))})
        elif ph == "e" and ev.get("cat") == "request":
            out.append({"kind": "request", "label": "complete", "t": t,
                        "replica": replica(ev),
                        "request_id": int(ev.get("id", -1))})
        elif ph == "i" and name in ("pressure_stall", "pressure_resume"):
            out.append({"kind": "request", "label": name, "t": t,
                        "replica": replica(ev),
                        "request_id": int(args.get("request_id", -1))})
    # Perfetto documents are unordered per spec; restore time order with
    # a stable sort so "emission order" checks see a consistent stream
    out.sort(key=lambda e: e["t"])
    return out


# -- the checker -------------------------------------------------------------


def check_events(events: Iterable, *, drained: bool = False,
                 must_drain: Sequence[str] = (),
                 ) -> InvariantReport:
    """Verify the happens-before invariants over ``events`` (emission
    order).  ``drained=True`` additionally enforces end-of-run
    conditions: no request left parked, admission stalls all resumed,
    and zero outstanding pages for the owner categories in
    ``must_drain`` (e.g. ``("prefetch",)`` after a full eviction; KV
    and cache-protected residency legitimately persist)."""
    evs = [_norm(e) for e in events]
    rep = InvariantReport(checked_events=len(evs))
    v = rep.violations.append

    def g(e, key, default=None):
        return e.get(key, default)

    # -- pass 1: correlation maps -------------------------------------------
    # (replica, transfer_id) -> land time; transfer sanity on the way
    land_t: Dict[Tuple[int, int], float] = {}
    for e in evs:
        if g(e, "kind") == "transfer.issue":
            r, tid = int(g(e, "replica", -1)), int(g(e, "transfer_id", -1))
            start, end = float(g(e, "start_t", 0.0)), float(g(e, "end_t", 0.0))
            land_t[(r, tid)] = end
            if end < start - EPS:
                v(InvariantViolation(
                    TRANSFER_INVERTED, t=float(g(e, "t", 0.0)), replica=r,
                    message=f"transfer {tid} lands at {end:.6f} before its "
                            f"own start {start:.6f}"))
            if start < float(g(e, "t", 0.0)) - EPS:
                v(InvariantViolation(
                    TRANSFER_INVERTED, t=float(g(e, "t", 0.0)), replica=r,
                    message=f"transfer {tid} starts at {start:.6f} before "
                            f"its submit at {g(e, 't'):.6f}"))
        elif g(e, "kind") == "transfer.land":
            r, tid = int(g(e, "replica", -1)), int(g(e, "transfer_id", -1))
            # a land event may carry a fresher end_t than the issue
            land_t.setdefault((r, tid), float(g(e, "t", 0.0)))

    # (replica, wave_id) -> earliest admission decision time
    admit_t: Dict[Tuple[int, int], float] = {}
    for e in evs:
        if g(e, "kind") in ("admission.admit", "admission.cap"):
            key = (int(g(e, "replica", -1)), int(g(e, "wave_id", -1)))
            t = float(g(e, "t", 0.0))
            if key[1] >= 0 and (key not in admit_t or t < admit_t[key]):
                admit_t[key] = t

    # -- pass 2: per-wave dispatch ordering ---------------------------------
    # wave.dispatch with a transfer: members' retrieve spans must start
    # at/after the transfer's landing, and admission must precede it
    dispatch: Dict[Tuple[int, int], Dict[str, object]] = {}
    for e in evs:
        if g(e, "kind") == "wave.dispatch":
            r, w = int(g(e, "replica", -1)), int(g(e, "wave_id", -1))
            dispatch[(r, w)] = e
            tid = int(g(e, "transfer_id", -1))
            t = float(g(e, "t", 0.0))
            if tid >= 0:
                at = admit_t.get((r, w))
                if at is None:
                    v(InvariantViolation(
                        DISPATCH_WITHOUT_ADMISSION, t=t, replica=r,
                        wave_id=w,
                        message=f"wave {w} moved bytes (transfer {tid}) "
                                f"with no admission decision on record"))
                elif at > t + EPS:
                    v(InvariantViolation(
                        DISPATCH_WITHOUT_ADMISSION, t=t, replica=r,
                        wave_id=w,
                        message=f"wave {w} dispatched at {t:.6f} before "
                                f"its admission at {at:.6f}"))

    for e in evs:
        if g(e, "kind") == "span" and g(e, "name") == "retrieve":
            r, w = int(g(e, "replica", -1)), int(g(e, "wave_id", -1))
            d = dispatch.get((r, w))
            if d is None:
                continue
            tid = int(g(d, "transfer_id", -1))
            if tid < 0:
                continue
            lt = land_t.get((r, tid))
            start = float(g(e, "t", 0.0))
            if lt is not None and start < lt - EPS:
                v(InvariantViolation(
                    USE_BEFORE_LAND, t=start, replica=r,
                    request_id=int(g(e, "request_id", -1)), wave_id=w,
                    message=f"retrieve starts at {start:.6f} but wave "
                            f"{w}'s transfer {tid} lands at {lt:.6f} — "
                            f"pages searched before the copy finished"))

    # -- pass 3: conservation (pool / kv), emission order -------------------
    pages_out: Dict[Tuple[int, str], int] = {}
    bytes_out: Dict[Tuple[int, str], int] = {}
    kv_out: Dict[int, int] = {}
    kv_replicas = {int(g(e, "replica", -1)) for e in evs
                   if str(g(e, "kind", "")).startswith("kv.")}
    kv_seen: Dict[int, bool] = {}
    # paged-lease discipline, keyed (replica, lease_id) for lease_id>=0:
    # open leases carry their acquired page count + max_len capacity
    paged_open: Dict[Tuple[int, int], Dict[str, int]] = {}
    paged_done: set = set()
    # dense bucket recycling, per replica: a dense kv.release parks the
    # bucket (+1), a recycled kv.acquire reuses one (-1), kv.drop
    # returns one's bytes to the pool (-1) — the balance never dips
    # below zero, or recycling double-counted a bucket
    recycle_pool: Dict[int, int] = {}
    # chunk-KV residency discipline, keyed (replica, doc_id): load →
    # pin*/unpin* (balanced, pins tracked) → evict at pin count zero
    chunk_open: Dict[Tuple[int, int], Dict[str, int]] = {}
    chunk_loads = 0
    for e in evs:
        kind = str(g(e, "kind", ""))
        if kind in ("pool.lease", "pool.release"):
            key = (int(g(e, "replica", -1)), str(g(e, "owner", "")))
            sign = 1 if kind == "pool.lease" else -1
            pages_out[key] = pages_out.get(key, 0) + sign * int(
                g(e, "pages", 0))
            bytes_out[key] = bytes_out.get(key, 0) + sign * int(
                g(e, "nbytes", 0))
            if pages_out[key] < 0:
                v(InvariantViolation(
                    DOUBLE_RELEASE, t=float(g(e, "t", 0.0)),
                    replica=key[0],
                    message=f"owner {key[1]!r} released more pages than "
                            f"it leased (balance {pages_out[key]})"))
                pages_out[key] = 0        # report once per dip, not per event
            if bytes_out[key] < 0:
                v(InvariantViolation(
                    LEDGER_DRIFT, t=float(g(e, "t", 0.0)), replica=key[0],
                    message=f"owner {key[1]!r} byte balance went negative "
                            f"({bytes_out[key]}) — release bytes exceed "
                            f"lease bytes"))
                bytes_out[key] = 0
        elif kind == "kv.acquire":
            r = int(g(e, "replica", -1))
            kv_out[r] = kv_out.get(r, 0) + 1
            kv_seen[r] = True
            lid = int(g(e, "lease_id", -1))
            if lid >= 0:
                key = (r, lid)
                if key in paged_open or key in paged_done:
                    v(InvariantViolation(
                        KV_LEASE_REUSE, t=float(g(e, "t", 0.0)), replica=r,
                        message=f"lease {lid} acquired twice — paged lease "
                                f"ids are unique by construction"))
                else:
                    paged_open[key] = {"pages": int(g(e, "pages", 0)),
                                       "max_len": int(g(e, "max_len", 0))}
            elif g(e, "recycled", False):
                bal = recycle_pool.get(r, 0)
                if bal <= 0:
                    v(InvariantViolation(
                        KV_RECYCLE_MISMATCH, t=float(g(e, "t", 0.0)),
                        replica=r,
                        message="recycled kv.acquire with no bucket parked "
                                "by a prior dense kv.release"))
                else:
                    recycle_pool[r] = bal - 1
        elif kind == "kv.append":
            r = int(g(e, "replica", -1))
            lid = int(g(e, "lease_id", -1))
            t = float(g(e, "t", 0.0))
            st = paged_open.get((r, lid)) if lid >= 0 else None
            if st is None:
                v(InvariantViolation(
                    KV_APPEND_OUT_OF_LEASE, t=t, replica=r,
                    message=f"kv.append for lease {lid} outside its "
                            f"acquire→release window (not an open paged "
                            f"lease on this replica)"))
            elif st["max_len"] > 0 and int(g(e, "length", 0)) > st["max_len"]:
                v(InvariantViolation(
                    KV_APPEND_OVERFLOW, t=t, replica=r,
                    message=f"kv.append advanced lease {lid} to length "
                            f"{g(e, 'length')} past its max_len "
                            f"{st['max_len']} capacity"))
        elif kind == "kv.splice":
            r = int(g(e, "replica", -1))
            lid = int(g(e, "lease_id", -1))
            t = float(g(e, "t", 0.0))
            st = paged_open.get((r, lid)) if lid >= 0 else None
            if st is None:
                v(InvariantViolation(
                    KV_SPLICE_OUT_OF_LEASE, t=t, replica=r,
                    message=f"kv.splice for lease {lid} outside its "
                            f"acquire→release window — chunk pages attached "
                            f"to a block table that is not live"))
            else:
                # the splice legitimately raises the lease's capacity
                # (chunk pages prepend at page boundaries); later appends
                # are bounded by the raised max_len
                st["max_len"] = max(st["max_len"], int(g(e, "max_len", 0)))
        elif kind == "kv.drop":
            r = int(g(e, "replica", -1))
            bal = recycle_pool.get(r, 0)
            if bal <= 0:
                v(InvariantViolation(
                    KV_RECYCLE_MISMATCH, t=float(g(e, "t", 0.0)), replica=r,
                    message="kv.drop with no bucket parked by a prior "
                            "dense kv.release"))
            else:
                recycle_pool[r] = bal - 1
        elif kind == "kv.release":
            r = int(g(e, "replica", -1))
            kv_out[r] = kv_out.get(r, 0) - 1
            if kv_out[r] < 0:
                v(InvariantViolation(
                    KV_DOUBLE_RELEASE, t=float(g(e, "t", 0.0)), replica=r,
                    message="kv.release without a matching kv.acquire"))
                kv_out[r] = 0
            lid = int(g(e, "lease_id", -1))
            if lid < 0:
                recycle_pool[r] = recycle_pool.get(r, 0) + 1
            if lid >= 0:
                key = (r, lid)
                st = paged_open.pop(key, None)
                t = float(g(e, "t", 0.0))
                if st is None:
                    v(InvariantViolation(
                        KV_DOUBLE_RELEASE, t=t, replica=r,
                        message=f"kv.release for lease {lid} that is not "
                                f"open (double release or never acquired)"))
                else:
                    paged_done.add(key)
                    rel = int(g(e, "pages", 0))
                    if rel != st["pages"]:
                        v(InvariantViolation(
                            KV_PAGE_CONSERVATION, t=t, replica=r,
                            message=f"lease {lid} released {rel} slab "
                                    f"pages but acquired {st['pages']} — "
                                    f"block-table pages leaked or "
                                    f"double-counted"))
        elif kind in ("chunk.load", "chunk.pin", "chunk.unpin",
                      "chunk.evict"):
            r = int(g(e, "replica", -1))
            d = int(g(e, "doc_id", -1))
            t = float(g(e, "t", 0.0))
            key = (r, d)
            st = chunk_open.get(key)
            if kind == "chunk.load":
                chunk_loads += 1
                if st is not None:
                    v(InvariantViolation(
                        CHUNK_PAGE_CONSERVATION, t=t, replica=r,
                        message=f"chunk {d} loaded twice without an "
                                f"intervening evict — {st['pages']} resident "
                                f"pages double-counted"))
                chunk_open[key] = {"pages": int(g(e, "pages", 0)), "pins": 0}
            elif kind == "chunk.pin":
                if st is None:
                    # the splice-before-land race: a block table is about
                    # to reference pages that were never landed
                    v(InvariantViolation(
                        CHUNK_PIN_BEFORE_LOAD, t=t, replica=r,
                        message=f"chunk {d} pinned before any chunk.load — "
                                f"splice would reference pages not on "
                                f"device"))
                else:
                    st["pins"] += 1
            elif kind == "chunk.unpin":
                if st is None or st["pins"] <= 0:
                    v(InvariantViolation(
                        CHUNK_UNPIN_WITHOUT_PIN, t=t, replica=r,
                        message=f"chunk {d} unpinned with no outstanding "
                                f"pin"))
                else:
                    st["pins"] -= 1
            else:                                  # chunk.evict
                if st is None:
                    v(InvariantViolation(
                        CHUNK_PAGE_CONSERVATION, t=t, replica=r,
                        message=f"chunk {d} evicted but never loaded"))
                else:
                    if st["pins"] > 0:
                        v(InvariantViolation(
                            CHUNK_EVICT_WHILE_PINNED, t=t, replica=r,
                            message=f"chunk {d} evicted while pinned "
                                    f"({st['pins']} pins) — spilled pages "
                                    f"out from under a live block table"))
                    rel = int(g(e, "pages", 0))
                    if rel != st["pages"]:
                        v(InvariantViolation(
                            CHUNK_PAGE_CONSERVATION, t=t, replica=r,
                            message=f"chunk {d} evicted {rel} pages but "
                                    f"loaded {st['pages']}"))
                    del chunk_open[key]
        elif kind == "decode":
            r = int(g(e, "replica", -1))
            if r in kv_replicas and not kv_seen.get(r):
                v(InvariantViolation(
                    DECODE_WITHOUT_KV, t=float(g(e, "t", 0.0)), replica=r,
                    request_id=int(g(e, "request_id", -1)),
                    message="decode step recorded before any kv.acquire "
                            "on this replica"))

    # -- pass 4: request lifecycle ------------------------------------------
    marks: Dict[Tuple[int, str], Tuple[float, str]] = {}
    first: Dict[Tuple[int, str], Dict[str, float]] = {}
    for e in evs:
        if g(e, "kind") != "request":
            continue
        rid = int(g(e, "request_id", -1))
        tenant = str(g(e, "tenant", "shared"))
        label = str(g(e, "label", ""))
        t = float(g(e, "t", 0.0))
        key = (rid, tenant)
        marks[key] = (t, label)
        first.setdefault(key, {}).setdefault(label, t)
    for (rid, _tenant), labels in first.items():
        a, c = labels.get("admit"), labels.get("complete")
        if a is not None and c is not None and c < a - EPS:
            v(InvariantViolation(
                LIFECYCLE_DISORDER, t=c, request_id=rid,
                message=f"request {rid} completes at {c:.6f} before its "
                        f"admit at {a:.6f}"))

    # -- pass 5: drained-only end conditions --------------------------------
    if drained:
        for (rid, _tenant), (t, label) in sorted(marks.items()):
            if label == "pressure_stall":
                v(InvariantViolation(
                    STALL_WITHOUT_RESUME, t=t, request_id=rid,
                    message=f"request {rid} ends its life parked "
                            f"(last mark is pressure_stall)"))
        stalls = sum(1 for e in evs if g(e, "kind") == "admission.stall")
        resumes = sum(1 for e in evs if g(e, "kind") == "admission.resume")
        if stalls > resumes:
            v(InvariantViolation(
                STALL_WITHOUT_RESUME, t=0.0,
                message=f"{stalls} admission stalls but only {resumes} "
                        f"resumes — parked waves never woke"))
        for (r, owner), bal in sorted(pages_out.items()):
            if owner in must_drain and bal > 0:
                v(InvariantViolation(
                    HELD_AT_DRAIN, replica=r,
                    message=f"owner {owner!r} still holds {bal} pages "
                            f"after drain"))
        for r, bal in sorted(kv_out.items()):
            if "kv" in must_drain and bal > 0:
                v(InvariantViolation(
                    HELD_AT_DRAIN, replica=r,
                    message=f"{bal} kv lease(s) still outstanding after "
                            f"drain"))
        if "kv" in must_drain:
            for (r, lid), st in sorted(paged_open.items()):
                v(InvariantViolation(
                    HELD_AT_DRAIN, replica=r,
                    message=f"paged lease {lid} still open after drain "
                            f"({st['pages']} slab pages held)"))
        if "chunk_kv" in must_drain:
            for (r, d), st in sorted(chunk_open.items()):
                v(InvariantViolation(
                    HELD_AT_DRAIN, replica=r,
                    message=f"chunk {d} still resident after drain "
                            f"({st['pages']} pages, {st['pins']} pins)"))

    rep.outstanding = {f"r{r}:{o}": bal
                       for (r, o), bal in sorted(pages_out.items()) if bal}
    rep.outstanding.update({f"r{r}:kv-leases": bal
                            for r, bal in sorted(kv_out.items()) if bal})
    rep.stats = {
        "transfers": len(land_t),
        "waves_dispatched": len(dispatch),
        "requests": len(first),
        "paged_leases": len(paged_done) + len(paged_open),
        "chunk_loads": chunk_loads,
        "pool_edges": sum(1 for e in evs
                          if str(g(e, "kind", "")).startswith("pool.")),
    }
    return rep


def check_recorder(rec, **kwargs) -> InvariantReport:
    """Convenience: run the checker on a live ``FlightRecorder``.  A
    recorder that dropped events (capacity ring) cannot satisfy
    conservation — its truncated window is skipped with an OK report."""
    if getattr(rec, "dropped", 0):
        return InvariantReport(checked_events=0,
                               stats={"skipped_dropped": rec.dropped})
    return check_events(rec.events, **kwargs)
