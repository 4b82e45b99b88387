"""Hybrid device/host IVF search + on-device merge (paper §4.1 steps 2–4).

* Device side: one fused ``probe_and_topk`` launch over the pool's
  resident pages (centroid probe, top-nprobe admission and masked top-k
  in the kernel, reading the slab in place), after the compute stream
  has waited on the lookahead copy's event.
* Host side: missed clusters are searched in numpy (the paper's
  multithreaded CPU path; one core here).
* Merge: only the host candidates' *scalar* scores+ids cross the link
  ("GPU sorting", §4.3 — transferring distances, not vectors), then one
  top-k on the device.

The unfused two-launch partition (host-built page mask + ``ivf_topk``)
and the datastore-sharded search wait for their kernel's port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.datastore import PagedClusters
from repro_torch.core.prefetch_buffer import PrefetchBuffer
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Host search (numpy — runs on the host CPU by construction)
# ---------------------------------------------------------------------------


def host_search(paged: PagedClusters, clusters: Sequence[int],
                query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Search the given clusters on the host. Returns (scores, ids) desc."""
    scores: List[np.ndarray] = []
    ids: List[np.ndarray] = []
    for c in clusters:
        pages = paged.cluster_pages(int(c))          # [np, ps, d]
        pid = paged.cluster_page_ids(int(c))
        flat = pages.reshape(-1, paged.dim)
        fid = pid.reshape(-1)
        valid = fid >= 0
        s = flat @ query
        s[~valid] = -np.inf
        scores.append(s)
        ids.append(fid)
    if not scores:
        return (np.full(k, -np.inf, np.float32), np.full(k, -1, np.int32))
    s = np.concatenate(scores)
    i = np.concatenate(ids)
    if len(s) > k:
        part = np.argpartition(-s, k - 1)[:k]
    else:
        part = np.arange(len(s))
    order = part[np.argsort(-s[part])]
    out_s = np.full(k, -np.inf, np.float32)
    out_i = np.full(k, -1, np.int32)
    out_s[:len(order)] = s[order]
    out_i[:len(order)] = i[order]
    return out_s, out_i


# ---------------------------------------------------------------------------
# On-device merge ("GPU sorting")
# ---------------------------------------------------------------------------


def merge_topk(dev_s: torch.Tensor, dev_i: torch.Tensor,
               host_s: torch.Tensor, host_i: torch.Tensor, k: int,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concat candidate lists and take global top-k per query (on device)."""
    s = torch.cat([dev_s, host_s], dim=-1)
    i = torch.cat([dev_i, host_i], dim=-1)
    top_s, idx = torch.topk(s, k, dim=-1)
    return top_s, torch.gather(i, -1, idx)


# ---------------------------------------------------------------------------
# Hybrid retrieval
# ---------------------------------------------------------------------------


@dataclass
class RetrievalResult:
    doc_ids: np.ndarray              # [B, k]
    scores: np.ndarray               # [B, k]
    hit_clusters: List[List[int]]    # per query: probed ∩ resident
    missed_clusters: List[List[int]] # per query: searched on host
    nprobe: int = 0

    @property
    def hit_rate(self) -> float:
        h = sum(len(x) for x in self.hit_clusters)
        m = sum(len(x) for x in self.missed_clusters)
        return h / max(h + m, 1)


def hybrid_retrieve(buffer: PrefetchBuffer, queries: np.ndarray,
                    probed_clusters: np.ndarray, *, k: int,
                    fused: bool = True,
                    centroids: Optional[torch.Tensor] = None,
                    ) -> RetrievalResult:
    """queries [B, d]; probed_clusters [B, nprobe] (ranked by q_out).

    Device searches every probed cluster that is resident; the host
    searches the rest; results merge on device.

    The device partition is ONE ``probe_and_topk`` launch over the pool's
    resident pages (``centroids`` [Nc, d] fp32 on the pool's device): the
    centroid probe, top-nprobe cluster admission and masked document
    top-k all happen in the kernel via the device page table
    (``page_cluster``).  The admitted cluster set equals
    ``probed_clusters`` when the kernel's fp32 centroid scores and the
    host probe's rank the nprobe-th cluster alike; the two sum in
    different orders, so a near-tie there can leave a resident cluster
    that neither side searches (ROADMAP, queue 3).
    """
    if not fused or centroids is None:
        raise NotImplementedError(
            "the unfused retrieval path (host-built page mask + ivf_topk) "
            "waits for the ivf_topk kernel port (ROADMAP: kernel 3); use "
            "fused=True with centroids")
    B, nprobe = probed_clusters.shape
    buffer.flush_invalidations()
    resident = buffer.resident_clusters()
    hit: List[List[int]] = []
    miss: List[List[int]] = []
    for b in range(B):
        cs = [int(c) for c in probed_clusters[b]]
        hit.append([c for c in cs if c in resident])
        miss.append([c for c in cs if c not in resident])

    dev = buffer.pool.device
    if dev.type == "cuda":
        buffer.wait_copies()                   # device-side wait, no host sync
    qd = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    # a page is searchable iff its cluster's centroid score reaches the
    # nprobe-th largest, which is exactly the probed set
    pages, page_ids, page_cluster = buffer.device_view()
    dev_s, dev_i = ops.probe_and_topk(qd, centroids, pages, page_ids,
                                      page_cluster, nprobe=nprobe, k=k)

    # host partition (scalar scores/ids only cross the link)
    host_results = [host_search(buffer.paged, miss[b], queries[b], k)
                    for b in range(B)]
    host_s = torch.as_tensor(np.stack([r[0] for r in host_results])).to(dev)
    host_i = torch.as_tensor(np.stack([r[1] for r in host_results])).to(dev)
    fs, fi = merge_topk(dev_s, dev_i, host_s, host_i, k)
    return RetrievalResult(doc_ids=fi.cpu().numpy(), scores=fs.cpu().numpy(),
                           hit_clusters=hit, missed_clusters=miss,
                           nprobe=nprobe)
