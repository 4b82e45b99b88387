"""Host-resident vector datastore with a paged IVF cluster layout.

The paper keeps the 61 GB Faiss index in CPU memory and moves whole IVF
clusters over PCIe on demand. Our TPU adaptation (DESIGN.md §2) stores
vectors host-side in *pages* of ``page_size`` vectors grouped by cluster:
a prefetch moves whole clusters (all their pages); the device buffer is a
fixed slab of page slots, so every transfer and every kernel sees static
shapes. Pages are the DMA unit; clusters remain the *policy* unit
(budgeting, caching, skip-if-over-budget — §4.3 of the paper).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Datastore:
    """Raw corpus: embeddings (+ optional payload texts) in host memory."""

    embeddings: np.ndarray          # [N, d] float32, unit-norm rows
    texts: Optional[List[str]] = None

    @property
    def num_vectors(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def nbytes(self) -> int:
        return self.embeddings.nbytes


def synthetic_datastore(num_vectors: int, dim: int = 768, *, seed: int = 0,
                        num_topics: int = 64) -> Datastore:
    """Clusterable synthetic corpus: topic centers + per-vector noise.

    Mirrors the geometry of real passage embeddings (locally clustered on
    the unit sphere) so IVF behaves realistically in tests/benchmarks.
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_topics, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = rng.integers(0, num_topics, size=num_vectors)
    emb = centers[topic] + 0.35 * rng.standard_normal((num_vectors, dim)).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
    return Datastore(embeddings=emb)


@dataclass
class PagedClusters:
    """Cluster-major paged layout of a datastore under an IVF assignment."""

    page_size: int
    dim: int
    # page-major storage: pages[i] is [page_size, d] (tail zero-padded)
    pages: np.ndarray               # [total_pages, page_size, d] float32
    page_ids: np.ndarray            # [total_pages, page_size] int32, -1 = pad
    page_cluster: np.ndarray        # [total_pages] int32 owning cluster
    cluster_first_page: np.ndarray  # [Nc] int32 index into pages
    cluster_num_pages: np.ndarray   # [Nc] int32
    cluster_sizes: np.ndarray       # [Nc] int32 (vector counts)

    @property
    def num_clusters(self) -> int:
        return len(self.cluster_sizes)

    @property
    def total_pages(self) -> int:
        return self.pages.shape[0]

    def cluster_pages(self, c: int) -> np.ndarray:
        f, n = self.cluster_first_page[c], self.cluster_num_pages[c]
        return self.pages[f:f + n]

    def cluster_page_ids(self, c: int) -> np.ndarray:
        f, n = self.cluster_first_page[c], self.cluster_num_pages[c]
        return self.page_ids[f:f + n]

    def cluster_bytes(self, c: int) -> int:
        """Transfer cost of cluster c (whole pages, vector payload)."""
        return int(self.cluster_num_pages[c]) * self.page_nbytes()

    def page_nbytes(self, dtype_bytes: int = 2) -> int:
        # transfers happen in bf16 (2 bytes): the device search runs in bf16
        return self.page_size * self.dim * dtype_bytes + self.page_size * 4

    def all_cluster_bytes(self) -> np.ndarray:
        return self.cluster_num_pages.astype(np.int64) * self.page_nbytes()


def build_paged_clusters(store: Datastore, assignments: np.ndarray,
                         num_clusters: int, page_size: int = 512,
                         ) -> PagedClusters:
    d = store.dim
    first_page: List[int] = []
    num_pages: List[int] = []
    sizes: List[int] = []
    pages: List[np.ndarray] = []
    pids: List[np.ndarray] = []
    pclust: List[int] = []
    order = np.argsort(assignments, kind="stable")
    bounds = np.searchsorted(assignments[order], np.arange(num_clusters + 1))
    for c in range(num_clusters):
        ids = order[bounds[c]:bounds[c + 1]]
        n = len(ids)
        npg = max(1, -(-n // page_size))
        first_page.append(len(pages))
        num_pages.append(npg)
        sizes.append(n)
        for p in range(npg):
            chunk = ids[p * page_size:(p + 1) * page_size]
            page = np.zeros((page_size, d), np.float32)
            pid = np.full(page_size, -1, np.int32)
            page[:len(chunk)] = store.embeddings[chunk]
            pid[:len(chunk)] = chunk
            pages.append(page)
            pids.append(pid)
            pclust.append(c)
    return PagedClusters(
        page_size=page_size, dim=d,
        pages=np.stack(pages), page_ids=np.stack(pids),
        page_cluster=np.asarray(pclust, np.int32),
        cluster_first_page=np.asarray(first_page, np.int32),
        cluster_num_pages=np.asarray(num_pages, np.int32),
        cluster_sizes=np.asarray(sizes, np.int32))
