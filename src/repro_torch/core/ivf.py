"""IVF index: k-means build + centroid probing (paper Appendix B), on the
device with PyTorch.

The coarse quantizer (centroid probe) is small — [Nc, d] — and runs on
the device every query (it is also what *lookahead* runs on q_in before
the rewrite exists).  The fine search over cluster contents is the
hybrid device/host search in ``hybrid_search.py``.

The initial centroids and the training sample come from the same numpy
``rng.choice`` draws as the reference, so a build from the same seed
starts from the same centroids.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.datastore import Datastore, PagedClusters, build_paged_clusters


@dataclass
class IVFIndex:
    centroids: np.ndarray       # [Nc, d] float32
    assignments: np.ndarray     # [N] int32
    paged: PagedClusters
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    _centroids_t: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def device_centroids(self) -> torch.Tensor:
        """The centroids as an fp32 tensor on ``device`` (made once)."""
        if self._centroids_t is None:
            self._centroids_t = torch.as_tensor(
                self.centroids, dtype=torch.float32).to(self.device)
        return self._centroids_t


# ---------------------------------------------------------------------------
# k-means (chunked over points so huge N never materializes [N, Nc])
# ---------------------------------------------------------------------------


def _assign(points: torch.Tensor, centroids: torch.Tensor,
            chunk: int = 65536) -> torch.Tensor:
    """Nearest centroid (inner product) per point; [N] int64."""
    return torch.cat([torch.argmax(p @ centroids.T, dim=-1)
                      for p in points.split(chunk)])


def _update(points: torch.Tensor, centroids: torch.Tensor,
            assign: torch.Tensor) -> torch.Tensor:
    """Spherical mean of each cluster's points (empty clusters keep their
    centroid), by ``index_add_`` instead of an [N, Nc] one-hot product."""
    nc = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, assign, points)
    counts = torch.bincount(assign, minlength=nc).to(points.dtype)[:, None]
    new = torch.where(counts > 0, sums / counts.clamp(min=1.0), centroids)
    norms = torch.linalg.norm(new, dim=-1, keepdim=True)
    return new / norms.clamp(min=1e-9)


def kmeans(points: np.ndarray, num_clusters: int, *, iters: int = 10,
           seed: int = 0, sample: Optional[int] = None,
           device: DeviceLike = "cuda") -> np.ndarray:
    """Spherical k-means (inner-product metric, matching the paper's index)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    train = points
    if sample is not None and sample < len(points):
        train = points[rng.choice(len(points), sample, replace=False)]
    init_idx = rng.choice(len(train), num_clusters, replace=False)
    cent = torch.as_tensor(train[init_idx], dtype=torch.float32).to(dev)
    pts = torch.as_tensor(train, dtype=torch.float32).to(dev)
    for _ in range(iters):
        cent = _update(pts, cent, _assign(pts, cent))
    return cent.cpu().numpy()


def build_ivf(store: Datastore, num_clusters: int, *, page_size: int = 512,
              kmeans_iters: int = 10, seed: int = 0,
              train_sample: Optional[int] = None,
              device: DeviceLike = "cuda") -> IVFIndex:
    """k-means over ``store`` (on ``device``), assign every vector, and
    lay the clusters out in pages.  The index keeps ``device``: the
    engine's page pool and probes run there."""
    dev = resolve_device(device)
    cent = kmeans(store.embeddings, num_clusters, iters=kmeans_iters,
                  seed=seed, sample=train_sample, device=dev)
    cent_t = torch.as_tensor(cent).to(dev)
    assign = _assign(torch.as_tensor(store.embeddings).to(dev),
                     cent_t).cpu().numpy()
    paged = build_paged_clusters(store, assign, num_clusters, page_size)
    return IVFIndex(centroids=cent, assignments=assign.astype(np.int32),
                    paged=paged, device=dev)


# ---------------------------------------------------------------------------
# Probing
# ---------------------------------------------------------------------------


def probe_device(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranked top-nprobe clusters per query. queries [B, d] -> ids [B, nprobe]."""
    sims = queries.float() @ centroids.float().T
    return torch.topk(sims, nprobe, dim=-1)


def probe(queries: np.ndarray, index: IVFIndex, nprobe: int) -> np.ndarray:
    """Host convenience wrapper; returns [B, nprobe] int32 cluster ids."""
    q = torch.as_tensor(np.atleast_2d(queries), dtype=torch.float32)
    _, ids = probe_device(q.to(index.device), index.device_centroids, nprobe)
    return ids.cpu().numpy().astype(np.int32)
