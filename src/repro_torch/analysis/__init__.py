"""telint for the port: static lint and dynamic trace invariant checking.

The reference's ``analysis`` package, with its scopes on
``src/repro_torch/``:

* ``lint`` — AST rules TL001, TL002, TL004 and TL005 over
  ``src/repro_torch`` (lease leaks, wall-clock reads outside the event
  clock, dropped tenant threading, swallowed ``PoolExhausted``),
  ratcheted against ``src/repro_torch/analysis/baseline.json``.  The
  reference's TL003 (kernel-mode literals) has no counterpart: the port
  has no mode switch.
* ``invariants`` — replays a ``FlightRecorder`` stream and checks the
  happens-before partial orders (transfer issue→land→use,
  admission→dispatch, lease→release, kv-acquire→decode→kv-release, the
  chunk-KV load→pin→unpin→evict discipline) plus conservation (no
  double release, no negative outstanding pages/bytes, leases drained
  at end of run).

``python -m repro_torch.analysis`` runs either half from the command
line.  Both modules are stdlib-only.
"""

from repro_torch.analysis.lint import LintViolation, lint_paths, lint_source
from repro_torch.analysis.invariants import (InvariantReport,
                                             InvariantViolation,
                                             check_events, check_recorder,
                                             events_from_jsonl,
                                             events_from_perfetto)

__all__ = [
    "LintViolation", "lint_paths", "lint_source",
    "InvariantReport", "InvariantViolation", "check_events",
    "check_recorder", "events_from_jsonl", "events_from_perfetto",
]
