"""The port's telint (``repro_torch.analysis``) against the reference's.

Every lint and invariant case of ``tests/test_analysis.py`` runs here
against the port's copy, with the lint scopes on ``src/repro_torch/``.
The reference's TL003 cases are left out: TL003 (an ``interpret=``
kwarg or an interpret-mode literal outside ``kernels/``) has no
counterpart, because the port has no kernel-mode switch, so the port's
lint has no such rule (``test_port_rules_are_the_reference_rules_but_tl003``
holds the rule set).  Beyond those cases: every hand-made stream gives
the same ``InvariantReport`` from both checkers, and so does the
flight-recorder stream of a port serve on the CPU (paged decode, so kv
leases too); ``lint_tree("src/repro_torch")`` finds nothing; the ratchet
against the port's (empty) ``baseline.json`` passes, in process and
through ``python -m repro_torch.analysis``; the TL001 regressions (a
raising decode hook, a raising ``init_cache``) hold in the port's
runtime; the injectable clock is deterministic.  Reports are compared
exactly (the checker is integer and float bookkeeping on the same
events, so there is no tolerance).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import check_events as jcheck_events
from repro.analysis import check_recorder as jcheck_recorder
from repro.analysis import lint as jlint
from repro_torch.analysis import (check_events, check_recorder,
                                  events_from_jsonl, events_from_perfetto,
                                  lint_source)
from repro_torch.analysis import invariants as inv
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.lint import dump_baseline, load_baseline, ratchet
from repro_torch.configs import get_arch
from repro_torch.core import datastore as tds
from repro_torch.core import ivf as tivf
from repro_torch.memory.pool import DevicePagePool
from repro_torch.models import transformer as ttf
from repro_torch.obs.clock import EventClock, SystemClock
from repro_torch.obs.export import to_perfetto, write_jsonl
from repro_torch.serving import api as tapi
from repro_torch.serving import kv_cache as kv_mod
from repro_torch.serving.decode import DecodeRunner
from repro_torch.serving.engine import EngineConfig, TeleRAGEngine
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.runtime import RequestState, RetrievalRuntime
from repro_torch.serving.trace import make_traces

ROOT = Path(__file__).resolve().parents[1]
BASELINE = "src/repro_torch/analysis/baseline.json"
SERVING = "src/repro_torch/serving/x.py"        # in TL002/TL004 scope
LAUNCH = "src/repro_torch/launch/x.py"          # outside the clocked core


def _rules(src, path=SERVING, only=None):
    return sorted({v.rule for v in lint_source(src, path, rules=only)})


# ---------------------------------------------------------------------------
# The rule set
# ---------------------------------------------------------------------------


def test_port_rules_are_the_reference_rules_but_tl003():
    names = lambda mod: [f.__name__ for f in mod._RULES]
    assert names(tlint) == [n for n in names(jlint) if n != "_check_tl003"]
    assert names(tlint) == ["_check_tl001", "_check_tl002", "_check_tl004",
                            "_check_tl005"]
    # the reference's TL003 snippets are not findings of the port's lint
    assert _rules("y = pallas_call(f, interpret=True)\n") == []
    assert _rules("res = search(q, kernel_mode='interpret')\n") == []


# every snippet of the lint cases below, with its scope
SNIPPETS = {
    "tl001_leak": ("def f(pool):\n"
                   "    lease = pool.lease_slots(4, owner='x')\n"
                   "    return 1\n"),
    "tl001_unprotected": ("def f(pool):\n"
                          "    lease = pool.lease_slots(4)\n"
                          "    work()\n"
                          "    pool.release(lease)\n"),
    "tl001_discard": ("def f(buffer, m, cs):\n"
                      "    buffer.pin_clusters(m, cs)\n"),
    "tl002": ("import time\n"
              "def f():\n"
              "    return time.perf_counter()\n"),
    "tl002_from": ("from time import perf_counter\n"
                   "def f():\n"
                   "    return perf_counter()\n"),
    "tl004": "t = eng.admission.admit(8, owner='w1')\n",
    "tl005_bare": "try:\n    f()\nexcept:\n    pass\n",
    "tl005_swallow": "try:\n    f()\nexcept PoolExhausted:\n    pass\n",
}


@pytest.mark.parametrize("name", list(SNIPPETS))
@pytest.mark.parametrize("scope", ["serving", "launch"])
def test_port_lint_findings_equal_the_reference_findings(name, scope):
    """Each snippet, linted at the same package path of each tree, gives
    the reference's findings with the path (and the clock module named in
    TL002's message) repointed."""
    src = SNIPPETS[name]
    ref = jlint.lint_source(src, f"src/repro/{scope}/x.py")
    port = lint_source(src, f"src/repro_torch/{scope}/x.py")
    repoint = lambda v: dataclasses.replace(
        v, path=v.path.replace("src/repro/", "src/repro_torch/"),
        message=v.message.replace("repro.obs.clock", "repro_torch.obs.clock"))
    assert [vars(v) for v in port] == [vars(repoint(v)) for v in ref]
    assert port or scope == "launch"


# ---------------------------------------------------------------------------
# TL001: lease leak
# ---------------------------------------------------------------------------


def test_tl001_unreleased_acquire_fires():
    vs = lint_source(SNIPPETS["tl001_leak"], SERVING, rules=("TL001",))
    assert [v.rule for v in vs] == ["TL001"]
    assert "never released" in vs[0].message
    assert vs[0].symbol == "f"


def test_tl001_release_without_protection_still_fires():
    vs = lint_source(SNIPPETS["tl001_unprotected"], SERVING,
                     rules=("TL001",))
    assert len(vs) == 1 and "not on exception paths" in vs[0].message


def test_tl001_try_finally_release_is_clean():
    src = ("def f(pool):\n"
           "    lease = pool.lease_slots(4)\n"
           "    try:\n"
           "        work()\n"
           "    finally:\n"
           "        pool.release(lease)\n")
    assert _rules(src, only=("TL001",)) == []


def test_tl001_except_cleanup_is_clean():
    src = ("def f(pool):\n"
           "    lease = pool.lease_slots(4)\n"
           "    try:\n"
           "        work()\n"
           "    except BaseException:\n"
           "        pool.release(lease)\n"
           "        raise\n")
    assert _rules(src, only=("TL001",)) == []


def test_tl001_escapes_are_clean():
    returned = ("def f(pool):\n"
                "    lease = pool.lease_slots(4)\n"
                "    return lease\n")
    stored = ("def f(self, pool):\n"
              "    lease = pool.lease_slots(4)\n"
              "    self.leases[3] = lease\n")
    appended = ("def f(pool, out):\n"
                "    lease = pool.lease_slots(4)\n"
                "    out.append(lease)\n")
    for src in (returned, stored, appended):
        assert _rules(src, only=("TL001",)) == []


def test_tl001_constructed_object_escape_is_clean():
    src = ("def f(self, pool, d):\n"
           "    lease = pool.lease_bytes(100, 'chunk_kv')\n"
           "    res = Residency(doc_id=d, lease=lease)\n"
           "    self.resident[d] = res\n")
    assert _rules(src, only=("TL001",)) == []
    src = ("def f(pool, d):\n"
           "    lease = pool.lease_bytes(100, 'chunk_kv')\n"
           "    res = Residency(doc_id=d, lease=lease)\n"
           "    return 1\n")
    assert _rules(src, only=("TL001",)) == ["TL001"]


def test_tl001_discarded_acquire_fires():
    vs = lint_source(SNIPPETS["tl001_discard"], SERVING, rules=("TL001",))
    assert len(vs) == 1 and "discarded" in vs[0].message
    assert vs[0].detail == "discard:pin_clusters"


def test_tl001_keyed_registry_release_excuses_discard():
    src = ("def f(buffer, m, cs):\n"
           "    try:\n"
           "        buffer.pin_clusters(m, cs)\n"
           "        work()\n"
           "    except BaseException:\n"
           "        buffer.unpin(m)\n"
           "        raise\n")
    assert _rules(src, only=("TL001",)) == []


def test_tl001_loop_alias_credits_the_iterated_list():
    src = ("def f(eng, keys, sets):\n"
           "    hit_pins = [eng.buffer.pin_clusters(m, cs)\n"
           "                for m, cs in zip(keys, sets)]\n"
           "    try:\n"
           "        work()\n"
           "    except BaseException:\n"
           "        for m in keys:\n"
           "            eng.buffer.unpin(m)\n"
           "        raise\n"
           "    for m, pins in zip(keys, hit_pins):\n"
           "        eng.buffer.release_pins(m, pins)\n")
    assert _rules(src, only=("TL001",)) == []


# ---------------------------------------------------------------------------
# TL002: wall-clock discipline
# ---------------------------------------------------------------------------


def test_tl002_wall_clock_in_core_fires_but_launch_is_exempt():
    src = SNIPPETS["tl002"]
    assert _rules(src, path=SERVING, only=("TL002",)) == ["TL002"]
    assert _rules(src, path=LAUNCH, only=("TL002",)) == []
    assert _rules(src, path="src/repro_torch/obs/clock.py",
                  only=("TL002",)) == []
    # the reference's tree is outside the port's scope
    assert _rules(src, path="src/repro/serving/x.py", only=("TL002",)) == []


def test_tl002_from_import_form_fires():
    vs = lint_source(SNIPPETS["tl002_from"], SERVING, rules=("TL002",))
    assert len(vs) == 1 and vs[0].detail == "perf_counter"
    assert "repro_torch.obs.clock" in vs[0].message


def test_tl002_non_clock_time_attrs_are_clean():
    src = ("import time\n"
           "def f():\n"
           "    time.sleep(0.1)\n")
    assert _rules(src, only=("TL002",)) == []


# ---------------------------------------------------------------------------
# TL004: tenant threading
# ---------------------------------------------------------------------------


def test_tl004_untenanted_admit_fires_in_scope_only():
    src = SNIPPETS["tl004"]
    assert "TL004" in _rules(src, path=SERVING, only=("TL004",))
    assert _rules(src, path=LAUNCH, only=("TL004",)) == []
    assert _rules("t = eng.admission.admit(8, tenant='a')\n",
                  only=("TL004",)) == []
    assert _rules("t = eng.admission.admit(8, **kw)\n",
                  only=("TL004",)) == []


# ---------------------------------------------------------------------------
# TL005: swallowed pressure
# ---------------------------------------------------------------------------


def test_tl005_bare_and_swallowing_excepts_fire():
    handled = "try:\n    f()\nexcept PoolExhausted:\n    park()\n"
    named = "try:\n    f()\nexcept ValueError:\n    pass\n"
    assert _rules(SNIPPETS["tl005_bare"], only=("TL005",)) == ["TL005"]
    assert _rules(SNIPPETS["tl005_swallow"], only=("TL005",)) == ["TL005"]
    assert _rules(handled, only=("TL005",)) == []
    assert _rules(named, only=("TL005",)) == []


# ---------------------------------------------------------------------------
# The port's own tree, and the ratchet
# ---------------------------------------------------------------------------


def test_lint_tree_of_the_port_finds_nothing():
    assert tlint.lint_tree("src/repro_torch", repo_root=str(ROOT)) == []
    assert tlint.lint_tree(repo_root=str(ROOT)) == []


def test_ratchet_against_the_port_baseline_passes():
    base = load_baseline(str(ROOT / BASELINE))
    assert base == {}
    new, stale = ratchet(tlint.lint_tree(repo_root=str(ROOT)), base)
    assert new == [] and stale == []


def test_ratchet_grandfathers_baseline_and_catches_new(tmp_path):
    leaky = SNIPPETS["tl001_leak"]
    vs = lint_source(leaky, SERVING, rules=("TL001",))
    path = str(tmp_path / "baseline.json")
    dump_baseline(vs, path)
    base = load_baseline(path)
    assert base == {vs[0].key: 1}
    new, stale = ratchet(vs, base)
    assert new == [] and stale == []
    vs2 = lint_source(leaky + "def g(pool):\n"
                              "    l2 = pool.lease_slots(2)\n"
                              "    return 1\n", SERVING,
                      rules=("TL001",))
    new, _ = ratchet(vs2, base)
    assert len(new) == 1 and new[0].symbol == "g"
    new, stale = ratchet([], base)
    assert new == [] and stale == [vs[0].key]


def test_baseline_schema_is_versioned(tmp_path):
    path = str(tmp_path / "b.json")
    with open(path, "w") as f:
        json.dump({"schema": "something-else", "violations": {}}, f)
    with pytest.raises(AssertionError):
        load_baseline(path)


def _cli(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=120)


def test_cli_ratchet_exits_zero_and_writes_a_report(tmp_path):
    report = tmp_path / "r" / "report.json"
    out = _cli("--ratchet", BASELINE, "--report", str(report))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new vs baseline" in out.stdout
    doc = json.loads(report.read_text())
    assert doc["mode"] == "static" and doc["new"] == [] and doc["total"] == 0


def test_cli_finds_a_planted_leak_and_rejects_bad_usage(tmp_path):
    tree = tmp_path / "src" / "repro_torch" / "serving"
    tree.mkdir(parents=True)
    (tree / "leak.py").write_text(SNIPPETS["tl001_leak"])
    out = _cli("--root", str(tmp_path / "src" / "repro_torch"))
    assert out.returncode == 1 and "TL001" in out.stdout
    assert _cli("--no-such-flag").returncode == 2


# ---------------------------------------------------------------------------
# Happens-before invariant checker: hand-corrupted streams
# ---------------------------------------------------------------------------


def _clean_stream():
    """A minimal well-ordered wave: admit -> reserve -> issue ->
    dispatch -> land -> retrieve -> release -> complete."""
    return [
        {"kind": "request", "label": "admit", "t": 0.0, "replica": -1,
         "request_id": 0, "tenant": "shared"},
        {"kind": "admission.admit", "t": 0.10, "replica": 0, "wave_id": 1,
         "owner": "w1", "pages_requested": 4, "pages_granted": 4},
        {"kind": "transfer.issue", "t": 0.10, "replica": 0,
         "transfer_id": 7, "nbytes": 100, "start_t": 0.10, "end_t": 0.30},
        {"kind": "wave.dispatch", "t": 0.10, "replica": 0, "wave_id": 1,
         "size": 1, "request_ids": (0,), "transfer_id": 7, "nbytes": 100},
        {"kind": "pool.lease", "t": 0.10, "replica": 0, "owner": "prefetch",
         "pages": 4, "nbytes": 100},
        {"kind": "span", "name": "retrieve", "t": 0.35, "dur": 0.01,
         "replica": 0, "request_id": 0, "wave_id": 1},
        {"kind": "pool.release", "t": 0.50, "replica": 0,
         "owner": "prefetch", "pages": 4, "nbytes": 100},
        {"kind": "request", "label": "complete", "t": 0.60, "replica": -1,
         "request_id": 0, "tenant": "shared"},
    ]


def test_clean_stream_passes_fully_drained():
    rep = check_events(_clean_stream(), drained=True,
                       must_drain=("prefetch", "kv"))
    assert rep.ok, rep.summary()
    assert rep.stats["transfers"] == 1
    assert rep.stats["waves_dispatched"] == 1
    assert rep.outstanding == {}


def test_use_before_land_race_is_caught():
    evs = _clean_stream()
    next(e for e in evs if e.get("name") == "retrieve")["t"] = 0.20
    rep = check_events(evs)
    assert rep.of(inv.USE_BEFORE_LAND), rep.summary()
    assert rep.of(inv.USE_BEFORE_LAND)[0].wave_id == 1


def test_dispatch_without_admission_is_caught():
    evs = [e for e in _clean_stream() if e["kind"] != "admission.admit"]
    assert check_events(evs).of(inv.DISPATCH_WITHOUT_ADMISSION)
    evs = _clean_stream()
    next(e for e in evs if e["kind"] == "admission.admit")["t"] = 0.2
    assert check_events(evs).of(inv.DISPATCH_WITHOUT_ADMISSION)


def test_double_release_and_ledger_drift_are_caught():
    evs = _clean_stream()
    evs.append({"kind": "pool.release", "t": 0.55, "replica": 0,
                "owner": "prefetch", "pages": 4, "nbytes": 100})
    assert check_events(evs).of(inv.DOUBLE_RELEASE)
    evs = _clean_stream()
    next(e for e in evs if e["kind"] == "pool.release")["nbytes"] = 160
    rep = check_events(evs)
    assert rep.of(inv.LEDGER_DRIFT) and not rep.of(inv.DOUBLE_RELEASE)


def test_held_at_drain_is_caught_only_for_named_owners():
    evs = [e for e in _clean_stream() if e["kind"] != "pool.release"]
    assert check_events(evs, drained=True,
                        must_drain=("prefetch",)).of(inv.HELD_AT_DRAIN)
    rep = check_events(evs, drained=True, must_drain=("kv",))
    assert rep.ok, rep.summary()
    assert rep.outstanding == {"r0:prefetch": 4}


def test_stall_without_resume_is_caught():
    evs = _clean_stream()
    evs.append({"kind": "request", "label": "pressure_stall", "t": 0.7,
                "replica": 0, "request_id": 0, "tenant": "shared"})
    assert check_events(evs, drained=True).of(inv.STALL_WITHOUT_RESUME)
    assert check_events(evs).ok


def test_transfer_inverted_and_lifecycle_disorder_are_caught():
    evs = _clean_stream()
    next(e for e in evs if e["kind"] == "transfer.issue")["end_t"] = 0.05
    assert check_events(evs).of(inv.TRANSFER_INVERTED)
    evs = _clean_stream()
    next(e for e in evs
         if e["kind"] == "request" and e["label"] == "complete")["t"] = -1.0
    assert check_events(evs).of(inv.LIFECYCLE_DISORDER)


def _kv_stream():
    return [
        {"kind": "kv.acquire", "t": 0.0, "replica": 0},
        {"kind": "decode", "t": 0.1, "replica": 0, "request_id": 3},
        {"kind": "kv.release", "t": 0.2, "replica": 0},
    ]


def test_kv_conservation_and_decode_ordering():
    good = _kv_stream()
    assert check_events(good, drained=True, must_drain=("kv",)).ok
    assert check_events(good + [{"kind": "kv.release", "t": 0.3,
                                 "replica": 0}]).of(inv.KV_DOUBLE_RELEASE)
    assert check_events([good[1], good[0], good[2]]).of(
        inv.DECODE_WITHOUT_KV)
    assert check_events(good[:2], drained=True,
                        must_drain=("kv",)).of(inv.HELD_AT_DRAIN)


def _paged_lease_stream(lease_id=5, pages=6, max_len=24, appends=3):
    evs = [{"kind": "kv.acquire", "t": 0.0, "replica": 0,
            "lease_id": lease_id, "pages": pages, "max_len": max_len,
            "batch": 2, "nbytes": 1000}]
    for i in range(appends):
        evs.append({"kind": "kv.append", "t": 0.1 + 0.1 * i, "replica": 0,
                    "lease_id": lease_id, "pages": pages,
                    "max_len": max_len, "length": i + 1})
    evs.append({"kind": "kv.release", "t": 0.9, "replica": 0,
                "lease_id": lease_id, "pages": pages, "max_len": max_len,
                "nbytes": 1000})
    return evs


def test_clean_paged_lease_stream_passes_drained():
    rep = check_events(_paged_lease_stream(), drained=True,
                       must_drain=("kv",))
    assert rep.ok, rep.summary()
    assert rep.stats["paged_leases"] == 1


def test_paged_append_outside_the_lease_is_caught():
    evs = _paged_lease_stream()
    evs.append({"kind": "kv.append", "t": 1.0, "replica": 0,
                "lease_id": 5, "pages": 6, "max_len": 24, "length": 4})
    assert check_events(evs).of(inv.KV_APPEND_OUT_OF_LEASE)
    evs = _paged_lease_stream()
    evs.insert(0, {"kind": "kv.append", "t": -0.1, "replica": 0,
                   "lease_id": 5, "pages": 6, "max_len": 24, "length": 1})
    assert check_events(evs).of(inv.KV_APPEND_OUT_OF_LEASE)
    evs = _paged_lease_stream()
    evs[1] = dict(evs[1], lease_id=99)
    assert check_events(evs).of(inv.KV_APPEND_OUT_OF_LEASE)


def test_paged_append_past_capacity_is_caught():
    evs = _paged_lease_stream(max_len=24)
    next(e for e in evs if e["kind"] == "kv.append")["length"] = 25
    assert check_events(evs).of(inv.KV_APPEND_OVERFLOW)


def test_paged_page_conservation_mismatch_at_release_is_caught():
    evs = _paged_lease_stream(pages=6)
    next(e for e in evs if e["kind"] == "kv.release")["pages"] = 5
    assert check_events(evs).of(inv.KV_PAGE_CONSERVATION)


def test_paged_lease_double_release_and_reuse_are_caught():
    evs = _paged_lease_stream()
    evs.append(dict(next(e for e in evs if e["kind"] == "kv.release"),
                    t=1.0))
    assert check_events(evs).of(inv.KV_DOUBLE_RELEASE)
    evs = _paged_lease_stream()
    evs.append(dict(evs[0], t=1.1))
    assert check_events(evs).of(inv.KV_LEASE_REUSE)


def test_open_paged_lease_is_held_at_drain():
    evs = [e for e in _paged_lease_stream() if e["kind"] != "kv.release"]
    assert check_events(evs, drained=True,
                        must_drain=("kv",)).of(inv.HELD_AT_DRAIN)
    assert check_events(evs).ok
    assert check_events(evs, drained=True, must_drain=("prefetch",)).ok


def _dense_lease_stream():
    return [
        {"kind": "kv.acquire", "t": 0.0, "replica": 0, "lease_id": -1},
        {"kind": "kv.release", "t": 0.2, "replica": 0, "lease_id": -1},
        {"kind": "kv.acquire", "t": 0.3, "replica": 0, "lease_id": -1},
        {"kind": "kv.release", "t": 0.5, "replica": 0, "lease_id": -1},
    ]


def test_dense_lease_events_are_exempt_from_paged_discipline():
    rep = check_events(_dense_lease_stream(), drained=True,
                       must_drain=("kv",))
    assert rep.ok, rep.summary()
    assert rep.stats["paged_leases"] == 0


def _spliced_lease_stream(lease_id=5, pages=6, max_len=24):
    return [
        {"kind": "kv.acquire", "t": 0.0, "replica": 0, "lease_id": lease_id,
         "pages": pages, "max_len": max_len, "batch": 1, "nbytes": 1000},
        {"kind": "kv.splice", "t": 0.05, "replica": 0, "lease_id": lease_id,
         "pages": 2, "max_len": max_len + 8, "batch": 1, "nbytes": 0},
        {"kind": "kv.append", "t": 0.1, "replica": 0, "lease_id": lease_id,
         "pages": pages, "max_len": max_len + 8, "length": max_len + 3},
        {"kind": "kv.release", "t": 0.9, "replica": 0, "lease_id": lease_id,
         "pages": pages, "max_len": max_len + 8, "nbytes": 1000},
    ]


def test_spliced_lease_stream_is_clean_and_raises_capacity():
    rep = check_events(_spliced_lease_stream(), drained=True,
                       must_drain=("kv",))
    assert rep.ok, rep.summary()
    evs = [e for e in _spliced_lease_stream() if e["kind"] != "kv.splice"]
    assert check_events(evs).of(inv.KV_APPEND_OVERFLOW)


def test_splice_outside_lease_window_is_caught():
    evs = _spliced_lease_stream()
    evs.append(dict(next(e for e in evs if e["kind"] == "kv.splice"),
                    t=1.0))
    assert check_events(evs).of(inv.KV_SPLICE_OUT_OF_LEASE)
    evs = _spliced_lease_stream()
    evs[1] = dict(evs[1], lease_id=99)
    assert check_events(evs).of(inv.KV_SPLICE_OUT_OF_LEASE)


def test_kv_drop_without_parked_bucket_is_caught():
    rep = check_events([{"kind": "kv.drop", "t": 0.1, "replica": 0}])
    assert rep.of(inv.KV_RECYCLE_MISMATCH), rep.summary()
    evs = [
        {"kind": "kv.acquire", "t": 0.0, "replica": 0, "lease_id": -1},
        {"kind": "kv.release", "t": 0.1, "replica": 0, "lease_id": -1},
        {"kind": "kv.drop", "t": 0.2, "replica": 0},
    ]
    assert check_events(evs, drained=True, must_drain=("kv",)).ok


def _chunk_stream(doc_id=7, pages=2):
    return [
        {"kind": "chunk.load", "t": 0.0, "replica": 0, "doc_id": doc_id,
         "pages": pages, "nbytes": 100, "pins": 0, "tenant": "shared"},
        {"kind": "chunk.pin", "t": 0.1, "replica": 0, "doc_id": doc_id,
         "pages": pages, "nbytes": 0, "pins": 1, "tenant": "shared"},
        {"kind": "chunk.unpin", "t": 0.2, "replica": 0, "doc_id": doc_id,
         "pages": pages, "nbytes": 0, "pins": 0, "tenant": "shared"},
        {"kind": "chunk.evict", "t": 0.3, "replica": 0, "doc_id": doc_id,
         "pages": pages, "nbytes": 100, "pins": 0, "tenant": "shared"},
    ]


def test_clean_chunk_stream_passes_and_counts_loads():
    rep = check_events(_chunk_stream(), drained=True,
                       must_drain=("chunk_kv",))
    assert rep.ok, rep.summary()
    assert rep.stats["chunk_loads"] == 1


def test_chunk_pin_before_load_is_caught():
    evs = [e for e in _chunk_stream() if e["kind"] != "chunk.load"]
    assert check_events(evs).of(inv.CHUNK_PIN_BEFORE_LOAD)


def test_chunk_unpin_without_pin_is_caught():
    evs = [e for e in _chunk_stream() if e["kind"] != "chunk.pin"]
    assert check_events(evs).of(inv.CHUNK_UNPIN_WITHOUT_PIN)
    evs = _chunk_stream()
    evs.insert(3, dict(evs[2], t=0.25))
    assert check_events(evs).of(inv.CHUNK_UNPIN_WITHOUT_PIN)


def test_chunk_evict_while_pinned_is_caught():
    evs = [e for e in _chunk_stream() if e["kind"] != "chunk.unpin"]
    assert check_events(evs).of(inv.CHUNK_EVICT_WHILE_PINNED)


def test_chunk_page_conservation_violations_are_caught():
    evs = _chunk_stream()
    evs.insert(1, dict(evs[0], t=0.05))
    assert check_events(evs).of(inv.CHUNK_PAGE_CONSERVATION)
    evs = [dict(e, doc_id=99) for e in _chunk_stream()
           if e["kind"] == "chunk.evict"]
    assert check_events(evs).of(inv.CHUNK_PAGE_CONSERVATION)
    evs = _chunk_stream()
    next(e for e in evs if e["kind"] == "chunk.evict")["pages"] = 1
    assert check_events(evs).of(inv.CHUNK_PAGE_CONSERVATION)


def test_warm_chunk_residency_at_drain_needs_opt_in():
    evs = [e for e in _chunk_stream() if e["kind"] != "chunk.evict"]
    assert check_events(evs, drained=True,
                        must_drain=("chunk_kv",)).of(inv.HELD_AT_DRAIN)
    assert check_events(evs, drained=True, must_drain=("kv",)).ok


def _corrupted(stream, kind, **changes):
    """``stream`` with the first event of ``kind`` changed (or dropped
    when ``changes`` is empty)."""
    out, done = [], False
    for e in stream:
        if not done and e["kind"] == kind:
            done = True
            if not changes:
                continue
            e = dict(e, **changes)
        out.append(e)
    return out


STREAMS = {
    "clean": _clean_stream(),
    "no_admission": _corrupted(_clean_stream(), "admission.admit"),
    "early_retrieve": [dict(e, t=0.2) if e.get("name") == "retrieve" else e
                       for e in _clean_stream()],
    "held_prefetch": _corrupted(_clean_stream(), "pool.release"),
    "drift": _corrupted(_clean_stream(), "pool.release", nbytes=160),
    "inverted": _corrupted(_clean_stream(), "transfer.issue", end_t=0.05),
    "kv": _kv_stream(),
    "kv_decode_first": [_kv_stream()[i] for i in (1, 0, 2)],
    "paged": _paged_lease_stream(),
    "paged_overflow": _corrupted(_paged_lease_stream(), "kv.append",
                                 length=25),
    "paged_open": _corrupted(_paged_lease_stream(), "kv.release"),
    "dense": _dense_lease_stream(),
    "spliced": _spliced_lease_stream(),
    "unspliced_overflow": _corrupted(_spliced_lease_stream(), "kv.splice"),
    "chunk": _chunk_stream(),
    "chunk_no_load": _corrupted(_chunk_stream(), "chunk.load"),
    "chunk_pinned_evict": _corrupted(_chunk_stream(), "chunk.unpin"),
    "chunk_short_evict": _corrupted(_chunk_stream(), "chunk.evict", pages=1),
}


def _report(rep):
    return (rep.ok, [vars(v) for v in rep.violations], rep.stats,
            rep.outstanding, rep.checked_events)


@pytest.mark.parametrize("drained", [False, True])
@pytest.mark.parametrize("name", list(STREAMS))
def test_reports_equal_the_reference_reports(name, drained):
    kw = dict(drained=drained, must_drain=("prefetch", "kv", "chunk_kv"))
    port = check_events(STREAMS[name], **kw)
    assert _report(port) == _report(jcheck_events(STREAMS[name], **kw))
    assert port.ok == (name in ("clean", "kv", "paged", "dense", "spliced",
                                "chunk") or (not drained and name in (
                                    "held_prefetch", "paged_open")))


# ---------------------------------------------------------------------------
# Invariants on a port serve's stream (CPU)
# ---------------------------------------------------------------------------


CFG = dict(nprobe=4, top_k=3, buffer_pages=40, lookahead_rank=8, chips=1,
           cache_enabled=True, seed=5)


@pytest.fixture(scope="module")
def world():
    store = tds.synthetic_datastore(3000, dim=32, seed=3)
    index = tivf.build_ivf(store, 16, page_size=32, kmeans_iters=4, seed=1,
                           train_sample=2000, device="cpu")
    rng = np.random.default_rng(0)
    q = store.embeddings[rng.choice(store.num_vectors, 12)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return index, q


def _serve(world, n=6):
    """A port server with paged decode (a reduced fp32 model) answers
    ``n`` irg requests on the CPU; returns the server."""
    index, q = world
    cfg = get_arch("llama3-8b").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    runner = DecodeRunner(model, max_len=32, max_steps=4, page_size=4,
                          slab_seqs=8)
    srv = tapi.TeleRAGServer(
        index, EngineConfig(**dict(CFG, pool_pages=40 + 64)), 1, cfg,
        micro_batch=2, include_tail=True, decode_hook=runner,
        continuous=True)
    runner.attach(srv)
    traces = make_traces("irg", n, seed=11)
    resp = srv.serve([tapi.RagRequest(q=q[i], trace=traces[i])
                      for i in range(n)])
    assert all(r.state is RequestState.COMPLETE for r in resp)
    return srv


def test_served_trace_gives_equal_reports_drained(world, tmp_path):
    srv = _serve(world)
    kw = dict(drained=True, must_drain=("kv",))
    rep = check_recorder(srv.recorder, **kw)
    assert rep.ok, rep.summary()
    assert rep.stats["waves_dispatched"] > 0 and rep.stats["pool_edges"] > 0
    assert rep.stats["paged_leases"] > 0
    assert _report(rep) == _report(jcheck_recorder(srv.recorder, **kw))
    # the lossless JSONL stream replays to the same report
    path = str(tmp_path / "stream.jsonl")
    write_jsonl(srv.recorder, path)
    assert _report(check_events(events_from_jsonl(path), **kw)) == \
        _report(rep)
    out = _cli("--trace", path, "--drained", "--must-drain", "kv")
    assert out.returncode == 0, out.stdout + out.stderr
    # one decode step moved before its lease: the checker and the CLI fail
    evs = events_from_jsonl(path)
    first = next(i for i, e in enumerate(evs) if e["kind"] == "kv.acquire")
    evs.insert(first, dict(next(e for e in evs if e["kind"] == "kv.append"),
                           t=evs[first]["t"]))
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps(e) + "\n" for e in evs))
    assert not check_events(events_from_jsonl(str(bad))).ok
    assert _cli("--trace", str(bad)).returncode == 1


def test_perfetto_reconstruction_passes_and_catches_races(world):
    srv = _serve(world)
    evs = events_from_perfetto(to_perfetto(srv.recorder))
    rep = check_events(evs)
    assert rep.ok, rep.summary()
    assert rep.stats["transfers"] > 0 and rep.stats["waves_dispatched"] > 0
    assert _report(rep) == _report(jcheck_events(evs))
    dispatch = next(e for e in evs if e["kind"] == "wave.dispatch"
                    and e["transfer_id"] >= 0)
    land = next(e for e in evs if e["kind"] == "transfer.land"
                and e["transfer_id"] == dispatch["transfer_id"]
                and e["replica"] == dispatch["replica"])
    moved = False
    for e in evs:
        if (e["kind"] == "span" and e.get("name") == "retrieve"
                and e["wave_id"] == dispatch["wave_id"]
                and e["replica"] == dispatch["replica"]):
            e["t"] = land["end_t"] - 1.0
            moved = True
    assert moved
    assert check_events(evs).of(inv.USE_BEFORE_LAND)


# ---------------------------------------------------------------------------
# Regressions the lint drove, in the port's runtime
# ---------------------------------------------------------------------------


def _engine(world):
    return TeleRAGEngine(world[0], EngineConfig(**dict(CFG,
                                                       cache_enabled=False)),
                         get_arch("llama3-8b"))


def test_raising_decode_hook_leaves_no_stranded_pages(world):
    def hook(records, gen_tokens, rnd):
        raise RuntimeError("decode died")

    eng = _engine(world)
    runtime = RetrievalRuntime(eng, on_generate=hook)
    for i, tr in enumerate(make_traces("hyde", 2, seed=3)):
        runtime.submit(world[1][i], tr)
    free_before = eng.pool.free_pages()
    with pytest.raises(RuntimeError):
        runtime.run()
    assert eng.pool.reserved_pages() == 0
    assert eng.buffer.pages_pinned_by_others(object()) == 0
    eng.end_batch()
    assert eng.pool.free_pages() == eng.pool.num_pages
    assert eng.pool.free_pages() >= free_before


def test_kv_acquire_releases_pages_when_init_cache_raises(world,
                                                          monkeypatch):
    cfg = get_arch("llama3-8b").reduced()
    pool = DevicePagePool(world[0].paged, num_pages=256, device="cpu")
    kv = KVCacheManager(cfg, pool=pool, device="cpu")
    free_before = pool.free_pages()

    def boom(*a, **kw):
        raise RuntimeError("OOM during init_cache")

    monkeypatch.setattr(kv_mod.tf, "init_cache", boom)
    with pytest.raises(RuntimeError):
        kv.acquire(2, 64, fresh=True)
    assert pool.free_pages() == free_before
    assert pool.reserved_pages() == 0


def test_event_clock_is_deterministic_and_system_clock_is_real():
    ec = EventClock()
    assert not ec.real
    assert ec.perf() == ec.perf() == 0.0
    sc = SystemClock()
    assert sc.real
    assert sc.perf() <= sc.perf()
