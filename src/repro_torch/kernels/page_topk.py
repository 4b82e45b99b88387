"""The work plan of the page search that both retrieval kernels share
(``csrc/page_topk.cuh``): how many rows a work unit holds, how deep the
ring of staged units is, how many queries a pass over the pages serves,
and how many blocks the persistent grid has.  Both wrappers
(``probe_topk.py``, ``ivf_topk.py``) pass ``plan``'s numbers to their
kernel, and ``smem_bytes`` mirrors the kernel's ``smem_layout``, so the
plan is known, and tested, on the host.
"""

from __future__ import annotations

import functools
from typing import Tuple

THREADS = 256              # threads a block (kThreads)
STAGE_BYTES = 48 * 1024    # bytes a staged unit holds at most
MAX_ROWS = 256             # rows a unit holds at most
MAX_STAGES = 4             # ring depth of the staged path (kMaxStages)
MAX_PASS = 8               # queries a pass (kMaxPass)
MAX_STAGED_D = 1024        # d a lane's register slices cover (kMaxPieces)
WINDOW = THREADS * 32 * 8  # pages one live-page bitmap covers (kWindow)
SMEM_LIMIT = 232448        # shared memory a block can have on the H100


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(rows: int, stages: int, qpass: int, d: int, k: int) -> int:
    """Dynamic shared memory of one block, as ``smem_layout`` lays it
    out: the stage ring, the mbarriers, the live-page bitmap, the
    double-buffered unit scores, the running lists and a few ints."""
    stage = _round_up(rows * d * 2, 128) if stages else 0
    fixed = stages * stage + 8 * MAX_STAGES + WINDOW // 8
    lists = _round_up(fixed + 2 * qpass * rows * 4 + 2 * qpass * k * 4, 16)
    return lists + 16 * 4


@functools.lru_cache(maxsize=1024)
def plan(B: int, P: int, ps: int, d: int, k: int, sms: int, aligned: bool,
         ) -> Tuple[int, int, int, int]:
    """(rows, stages, queries a pass, blocks) for a search of B queries
    over P pages of ps rows of d bf16 values, top-k, on a card of
    ``sms`` SMs.  A unit is at most ``STAGE_BYTES`` of one page's rows;
    the grid is one block per SM (fewer when there are fewer units).
    The staged path (16-byte bulk copies into a ring of stages) takes
    ``aligned`` pages with d % 8 == 0 and d <= 1024, else stages is 0
    and the kernel reads the rows directly.  Deeper rings come before
    larger passes when shared memory is short; raises ValueError when
    even one query's list does not fit."""
    rows = max(1, min(ps, MAX_ROWS, STAGE_BYTES // (2 * d)))
    blocks = max(1, min(sms, P * -(-ps // rows)))
    staged = aligned and d % 8 == 0 and d <= MAX_STAGED_D
    passes = []
    q = min(max(B, 1), MAX_PASS)
    while True:
        passes.append(q)
        if q == 1:
            break
        q //= 2
    for stages in ((MAX_STAGES, 3, 2) if staged else ()) + (0,):
        for qpass in passes:
            if smem_bytes(rows, stages, qpass, d, k) <= SMEM_LIMIT:
                return rows, stages, qpass, blocks
    raise ValueError(f"k={k} is too large for the search kernel's shared "
                     f"memory (a query's list takes 8 * k bytes)")
