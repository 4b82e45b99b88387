"""Injectable clock sources: the wall-clock discipline boundary.

Everything inside the deterministic core (serving / memory / core /
obs) times itself on the **shared event clock** — modeled seconds the
runtimes advance. The few places that look like they need real wall
time (scheduler overhead sampling in ``TeleRAGServer._route_wave``,
host-search calibration in ``TeleRAGEngine.calibrate_tcc``) take one
of these clock objects instead of calling ``time.perf_counter()``
directly, so:

  * default runs are **replay-deterministic** — the same inputs give
    the same trace, byte for byte (``EventClock`` reads the flight
    recorder's cursor, which only moves with modeled events);
  * real measurement is an explicit opt-in at the launch layer
    (``launch/serve.py`` injects ``SystemClock``), not an ambient
    side effect;
  * telint's TL002 rule can keep a one-file allowlist: this module is
    the single sanctioned ``time`` import in the core.
"""

from __future__ import annotations

import time
from typing import Optional


class SystemClock:
    """Real wall time.  The ONE sanctioned ``time.perf_counter`` call
    site inside the deterministic core (telint TL002 allowlists this
    file) — inject it where real measurement is wanted."""

    #: real clocks measure; deterministic ones return modeled/zero time
    real = True

    def perf(self) -> float:
        return time.perf_counter()


class EventClock:
    """Deterministic clock: reads the flight recorder's event-clock
    cursor (modeled seconds).  Two ``perf()`` calls bracketing host
    work return the same value — elapsed wall time is 0.0 by design,
    so consumers that *measure* must either accept the modeled zero
    (``sched_overhead_s`` in replayable runs) or fall back to a
    modeled estimate (``calibrate_tcc``)."""

    real = False

    def __init__(self, recorder: Optional[object] = None):
        self.recorder = recorder

    def perf(self) -> float:
        rec = self.recorder
        return float(getattr(rec, "now", 0.0)) if rec is not None else 0.0


SYSTEM_CLOCK = SystemClock()
