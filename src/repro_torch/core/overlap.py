"""Cluster-overlap analytics (paper §3.3, Table 1).

Coverage = |C_in ∩ C_out| / |C_out| at a given nprobe: the fraction of
clusters the rewritten query actually probes that the *input* query
predicted. The six pipelines differ in how far the rewrite moves the
embedding; we model each pipeline's rewrite strength as a perturbation
sigma calibrated so baseline coverage lands in the paper's Table 1 band.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import ivf as ivf_mod
from repro_torch.core.embedder import synthetic_rewrite
from repro_torch.core.ivf import IVFIndex


# Per-pipeline rewrite strengths, CALIBRATED so that cluster coverage on
# the benchmark index (320k x 256d, 256 clusters, nprobe 64) matches the
# paper's Table 1 NQ row (the calibration sweep lives in
# benchmarks/bench_overlap.py; see EXPERIMENTS.md). Self-RAG performs no
# query transform => coverage 100% by construction. Ordering matches the
# paper: Iter mildest rewrite, SubQ decomposition the strongest.
PIPELINE_SIGMA: Dict[str, float] = {
    "hyde": 0.0375,     # target coverage 0.731
    "subq": 0.0550,     # target coverage 0.632
    "iter": 0.0100,     # target coverage 0.915
    "irg": 0.0200,      # target coverage 0.838
    "flare": 0.0275,    # target coverage 0.791
    "self_rag": 0.0,    # 1.000 by construction
}


def coverage(index: IVFIndex, q_in: np.ndarray, q_out: np.ndarray,
             nprobe: int) -> float:
    """Average |C_in ∩ C_out| / |C_out| over the query batch."""
    cin = ivf_mod.probe(q_in, index, nprobe)
    cout = ivf_mod.probe(q_out, index, nprobe)
    covs = []
    for a, b in zip(cin, cout):
        sa, sb = set(a.tolist()), set(b.tolist())
        covs.append(len(sa & sb) / max(len(sb), 1))
    return float(np.mean(covs))


def pipeline_pairs(queries: np.ndarray, pipeline: str, *, seed: int = 0,
                   rounds: int = 1) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(q_in, q_out) pairs for a pipeline; multi-round pipelines drift
    cumulatively (each round rewrites the previous round's query)."""
    rng = np.random.default_rng(seed)
    sigma = PIPELINE_SIGMA[pipeline]
    pairs = []
    q = queries
    for _ in range(max(rounds, 1)):
        q_out = synthetic_rewrite(q, sigma, rng) if sigma > 0 else q.copy()
        pairs.append((q, q_out))
        q = q_out
    return pairs


def overlap_table(index: IVFIndex, queries: np.ndarray, nprobe: int, *,
                  seed: int = 0) -> Dict[str, float]:
    """Table-1 analog: coverage per pipeline at the given nprobe."""
    out = {}
    for name in PIPELINE_SIGMA:
        q_in, q_out = pipeline_pairs(queries, name, seed=seed)[0]
        out[name] = coverage(index, q_in, q_out, nprobe)
    return out
