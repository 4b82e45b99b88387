"""telint for the port: the lease/clock lint over ``src/repro_torch`` and
the trace invariant checker, from the command line (the port's
counterpart of the reference's ``tools/telint.py``, with its flags).

Static lint (rules TL001, TL002, TL004, TL005), ratcheted:

  python -m repro_torch.analysis                  # list all findings
  python -m repro_torch.analysis --ratchet src/repro_torch/analysis/baseline.json
                                                  # fail only on NEW ones
  python -m repro_torch.analysis --update-baseline src/repro_torch/analysis/baseline.json
                                                  # re-grandfather

Dynamic happens-before check on a recorded trace (JSONL stream from
``repro_torch.obs.export.write_jsonl`` = full checks; Perfetto JSON =
the span/transfer/admission subset), e.g. the files that
``python -m repro_torch.launch.serve --trace-out PATH`` writes:

  python -m repro_torch.analysis --trace trace.jsonl --drained

``--root`` and the baseline paths are taken from the repository root
(two levels above ``src/repro_torch``), ``--trace`` and ``--report``
from the working directory, as ``tools/telint.py`` takes them.
``--report out.json`` writes a machine-readable report.  Exit status:
0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.analysis import invariants as inv
from repro_torch.analysis import lint as lint_mod

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, os.pardir, os.pardir))


def run_static(args: argparse.Namespace) -> Tuple[int, Dict]:
    """(exit code, report dict) for the static half."""
    violations = lint_mod.lint_tree(args.root, repo_root=REPO_ROOT,
                                    rules=args.rules)
    report = {"mode": "static", "root": args.root,
              "total": len(violations),
              "violations": [vars(v) for v in violations]}
    if args.update_baseline:
        lint_mod.dump_baseline(violations,
                               os.path.join(REPO_ROOT, args.update_baseline))
        print(f"baseline updated: {args.update_baseline} "
              f"({len(violations)} grandfathered finding(s))")
        return 0, report
    if args.ratchet:
        baseline = lint_mod.load_baseline(os.path.join(REPO_ROOT,
                                                       args.ratchet))
        new, stale = lint_mod.ratchet(violations, baseline)
        report.update(baseline=args.ratchet, new=[vars(v) for v in new],
                      stale=stale)
        for v in new:
            print(v.render())
        if stale:
            print(f"note: {len(stale)} baseline entr"
                  f"{'y is' if len(stale) == 1 else 'ies are'} stale "
                  f"(fixed since grandfathering) — run "
                  f"--update-baseline to tighten the ratchet:")
            for k in stale:
                print(f"  {k}")
        print(f"telint: {len(violations)} finding(s), "
              f"{len(new)} new vs baseline ({len(baseline)} grandfathered)")
        return (1 if new else 0), report
    for v in violations:
        print(v.render())
    print(f"telint: {len(violations)} finding(s)")
    return (1 if violations else 0), report


def run_trace(args: argparse.Namespace) -> Tuple[int, Dict]:
    """(exit code, report dict) for the dynamic half."""
    path = args.trace
    if path.endswith(".jsonl"):
        events, source = inv.events_from_jsonl(path), "jsonl"
    else:
        with open(path) as f:
            events = inv.events_from_perfetto(json.load(f))
        source = "perfetto"
        print("note: Perfetto input — race/ordering checks only "
              "(pool conservation needs the .jsonl stream)")
    rep = inv.check_events(events, drained=args.drained,
                           must_drain=tuple(args.must_drain or ()))
    for v in rep.violations:
        print(v.render())
    print(f"{path} ({source}): {rep.summary()}")
    report = {"mode": "trace", "trace": path, "source": source,
              "checked_events": rep.checked_events, "stats": rep.stats,
              "outstanding": rep.outstanding,
              "violations": [vars(v) for v in rep.violations]}
    return (0 if rep.ok else 1), report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="src/repro_torch",
                    help="tree to lint (repo-relative; default "
                         "src/repro_torch)")
    ap.add_argument("--rules", nargs="*", default=None, metavar="TLnnn",
                    help="restrict to specific rule ids")
    ap.add_argument("--ratchet", default=None, metavar="BASELINE",
                    help="fail only on findings NOT in this baseline")
    ap.add_argument("--update-baseline", default=None, metavar="BASELINE",
                    help="write the current findings as the new baseline")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="check happens-before invariants on a recorded "
                         "trace (.jsonl = full checks, .json Perfetto = "
                         "ordering subset) instead of linting")
    ap.add_argument("--drained", action="store_true",
                    help="with --trace: the stream covers a full drain — "
                         "also enforce end-of-run conditions")
    ap.add_argument("--must-drain", nargs="*", default=None, metavar="OWNER",
                    help="with --trace --drained: owner categories whose "
                         "pool balance must end at zero (e.g. prefetch kv)")
    ap.add_argument("--report", default=None, metavar="OUT.json",
                    help="write a machine-readable findings report")
    args = ap.parse_args(argv)

    code, report = run_trace(args) if args.trace else run_static(args)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written: {args.report}")
    return code


if __name__ == "__main__":
    sys.exit(main())
