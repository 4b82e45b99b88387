"""The ONE telemetry text renderer.

``ServerTelemetry.summary()`` / ``TenantTelemetry.line()`` used to
format themselves inline in ``serving/api.py``, and the two row types
had drifted: replica rows printed percentages at ``.1%`` and megabytes
at ``.1f`` while tenant rows truncated to ``.0%`` / mixed ``.2f`` —
so a 99.5% attainment printed as ``100%`` while the replica one line up
showed ``99.5%``.  All telemetry printing now goes through the shared
formatters here (same precision on every row), and the serving
dataclasses delegate.

Duck-typed on purpose: the functions read the public telemetry fields
(``repro_torch.obs`` never imports from ``repro_torch.serving``).
"""

from __future__ import annotations

from typing import List


def fmt_pct(x: float) -> str:
    """Uniform percentage rendering (one decimal, every row type)."""
    return f"{x:.1%}"


def fmt_mb(nbytes: float) -> str:
    """Uniform megabyte rendering (two decimals, every row type)."""
    return f"{nbytes / 1e6:.2f}MB"


def fmt_ms(seconds: float) -> str:
    """Uniform millisecond rendering (one decimal)."""
    return f"{seconds * 1e3:.1f}ms"


def render_replica_line(r) -> str:
    """One replica's row (a ``ReplicaTelemetry``)."""
    led = r.ledger
    return (f"replica {r.replica}: h2d={fmt_mb(r.bytes_h2d)} "
            f"cache_hit={fmt_pct(r.cache_hit_rate)} "
            f"occ={fmt_pct(r.occupancy)} "
            f"prefetch={fmt_mb(led.get('prefetch', 0))} "
            f"kv={fmt_mb(led.get('kv', 0))} "
            f"peak={led.get('peak', 0) / 1e9:.2f}GB "
            f"transfers={r.transfers} "
            f"(queued {fmt_ms(r.transfer_queued_s)})")


def render_tenant_line(t) -> str:
    """One tenant's row (a ``TenantTelemetry``)."""
    return (f"tenant {t.tenant}: {t.completed} done "
            f"p50={fmt_ms(t.p50_latency_s)} "
            f"p99={fmt_ms(t.p99_latency_s)} "
            f"queue_mean={fmt_ms(t.mean_queue_s)} "
            f"attain={fmt_pct(t.attainment)} "
            f"miss={t.deadline_missed} "
            f"(queue {t.missed_in_queue} / "
            f"service {t.missed_in_service}) "
            f"stall={fmt_ms(t.stall_s)} "
            f"demoted={t.demoted_rounds} "
            f"kv={fmt_mb(t.kv_bytes)}")


def render_telemetry(st) -> str:
    """The full multi-line snapshot (a ``ServerTelemetry``): fleet
    totals, one row per replica, one row per tenant — every row through
    the same formatters."""
    lines: List[str] = [
        f"server: {st.completed} completed / {st.waves} waves / "
        f"{st.dispatched_batches} micro-batches, "
        f"clock={fmt_ms(st.clock_s)}, "
        f"h2d={fmt_mb(st.bytes_h2d)}, "
        f"admission admitted={st.admission_admitted} "
        f"stalled={st.admission_stalled} "
        f"spilled_pages={st.spilled_pages}"]
    lines.extend("  " + render_replica_line(r) for r in st.replicas)
    lines.extend("  " + render_tenant_line(t) for t in st.tenants)
    return "\n".join(lines)
