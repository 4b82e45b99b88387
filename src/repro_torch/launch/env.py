"""Recommended process environment for serving, training and benchmark
launches of the port (the reference's ``launch/env.py``).

The host-side knobs carry over unchanged: tcmalloc preloaded for the
allocation-heavy host paths (the event loop, the host search over
missed clusters, the datastore build), and its large-allocation warning
threshold raised past slab sizes, so it never prints mid-benchmark.

The reference's other knobs have no counterpart in a process that runs
neither TensorFlow nor XLA: ``TF_CPP_MIN_LOG_LEVEL`` silences
TensorFlow's C++ logging, and ``XLA_FLAGS`` pins XLA's step marker and
forces a host-platform device count for CPU meshes.  The port's CPU
meshes are gloo process groups instead (``tests/torch_dist_ranks.py``),
one process a rank, so it needs no forced device count.

``recommended_env()`` computes the knobs for this machine,
``render_shell()`` prints a source-able shell snippet, and
``validate()`` reports which recommendations the current process lacks.
``launch/serve.py --print-env`` and ``python -m repro_torch.launch.env``
print the snippet.  None of this is needed for correctness: it is the
performance-hygiene layer, and everything works without tcmalloc.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
)

# raised past any slab/datastore allocation so tcmalloc never warns
# mid-benchmark (the warning itself perturbs timing)
LARGE_ALLOC_THRESHOLD = 60_000_000_000


def _find_tcmalloc() -> Optional[str]:
    for p in TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def recommended_env() -> Dict[str, str]:
    """The recommended launch environment for THIS machine (LD_PRELOAD
    absent when no tcmalloc is installed)."""
    env: Dict[str, str] = {}
    tc = _find_tcmalloc()
    if tc is not None:
        env["LD_PRELOAD"] = tc
    env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = str(LARGE_ALLOC_THRESHOLD)
    return env


def render_shell() -> str:
    """Source-able shell snippet of ``recommended_env`` (export lines)."""
    env = recommended_env()
    lines = ["# repro_torch launch env (generated by repro_torch.launch.env)"]
    for key, val in env.items():
        lines.append(f'export {key}="{val}"')
    if "LD_PRELOAD" not in env:
        lines.append("# (tcmalloc not found — LD_PRELOAD skipped)")
    return "\n".join(lines)


def validate() -> List[Tuple[str, str, str]]:
    """Compare the live process env against the recommendation; returns
    (key, want, have) for every divergence ("" = unset)."""
    return [(key, want, os.environ.get(key, ""))
            for key, want in recommended_env().items()
            if os.environ.get(key, "") != want]


def print_env() -> None:
    """Print the snippet plus a divergence report for the live process."""
    print(render_shell())
    diffs = validate()
    if not diffs:
        print("# current process: all recommendations active")
    for key, want, have in diffs:
        print(f"# current process: {key} = {have!r} (want {want!r})")


if __name__ == "__main__":
    print_env()
