"""Deterministic text featurizer — offline stand-in for Contriever.

Hash-n-gram bag-of-features projected through a fixed seeded Gaussian
matrix, L2-normalized. Deterministic across processes (no pretrained
weights ship offline), which is what the cluster-overlap and hit-rate
experiments need: *relative* geometry of (q_in, q_out) pairs, not absolute
retrieval quality. See DESIGN.md §2 "Embedding model".
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

DEFAULT_DIM = 768
_N_BUCKETS = 8192


def _stable_hash(token: str) -> int:
    return int.from_bytes(hashlib.blake2s(token.encode(), digest_size=4).digest(),
                          "little")


class HashEmbedder:
    """Text -> unit vector in R^dim; deterministic given (dim, seed)."""

    def __init__(self, dim: int = DEFAULT_DIM, seed: int = 0):
        self.dim = dim
        rng = np.random.default_rng(seed)
        # projection from hashed n-gram buckets to the embedding space
        self._proj = rng.standard_normal((_N_BUCKETS, dim)).astype(np.float32)
        self._proj /= np.sqrt(dim)

    def _features(self, text: str) -> np.ndarray:
        counts = np.zeros(_N_BUCKETS, np.float32)
        words = text.lower().split()
        grams: List[str] = list(words)
        grams += [" ".join(words[i:i + 2]) for i in range(len(words) - 1)]
        for g in grams:
            counts[_stable_hash(g) % _N_BUCKETS] += 1.0
        return counts

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        feats = np.stack([self._features(t) for t in texts])
        emb = feats @ self._proj
        norms = np.linalg.norm(emb, axis=-1, keepdims=True)
        return emb / np.maximum(norms, 1e-9)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


def synthetic_rewrite(q: np.ndarray, sigma: float, rng: np.random.Generator,
                      ) -> np.ndarray:
    """Perturbed embedding standing in for the LLM's query transformation.

    The pre-retrieval LLM rewrites the query while preserving its core
    semantics (paper §3.3); geometrically this is a small rotation of the
    embedding. sigma is calibrated per pipeline so that the resulting IVF
    cluster overlap matches the paper's Table 1 band (see
    benchmarks/bench_overlap.py).
    """
    noise = rng.standard_normal(q.shape).astype(np.float32)
    out = q + sigma * noise
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-9)
