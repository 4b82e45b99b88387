"""Hybrid device/host IVF search + on-device merge (paper §4.1 steps 2–4).

* Device side, fused (the default): one ``probe_topk_fused`` launch over
  the pool's resident pages (centroid probe, top-nprobe admission and
  masked top-k in the kernel, reading the slab in place).  The kernel's
  admitted-cluster mask, read back once, splits hits from misses, so the
  device and the host search exactly the clusters the kernel admitted;
  the host search over the host probe's misses runs while the kernel
  does, and is redone only where the mask disagrees.
* Device side, unfused: a per-query page mask built on the host from the
  resident probed clusters, then one ``ivf_topk`` launch over the slab.
* Either way the compute stream first waits on the lookahead copy's
  event (a device-side wait).
* Host side: missed clusters are searched in numpy (the paper's
  multithreaded CPU path; one core here).
* Merge: only the host candidates' *scalar* scores+ids cross the link
  ("GPU sorting", §4.3 — transferring distances, not vectors), then one
  top-k on the device.

Beyond the paper (its §7): ``sharded_device_search``, the datastore
sharded over the ranks of a process group along the page dim: a local
top-k a rank (kernel 3), then an all-gather of the k candidates alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.datastore import PagedClusters
from repro_torch.core.prefetch_buffer import PrefetchBuffer
from repro_torch.kernels import ops
from repro_torch.kernels import probe_topk


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


def _host_merge(buffer: PrefetchBuffer, queries: np.ndarray,
                miss: List[List[int]], dev_s: torch.Tensor,
                dev_i: torch.Tensor, k: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host partition over each query's ``miss`` clusters (scalar
    scores/ids only cross the link), merged on device with the device
    partition's candidates.  On a card the upload is pinned and
    ``non_blocking``, so nothing here waits for the device search."""
    host_results = [host_search(buffer.paged, miss[b], queries[b], k)
                    for b in range(len(miss))]
    dev = dev_s.device

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    host_s = upload(np.stack([r[0] for r in host_results]))
    host_i = upload(np.stack([r[1] for r in host_results]))
    return merge_topk(dev_s, dev_i, host_s, host_i, k)


def hybrid_retrieve(buffer: PrefetchBuffer, queries: np.ndarray,
                    probed_clusters: np.ndarray, *, k: int,
                    fused: bool = True,
                    centroids: Optional[torch.Tensor] = None,
                    ) -> RetrievalResult:
    """queries [B, d]; probed_clusters [B, nprobe] (ranked by q_out).

    Device searches every probed cluster that is resident; the host
    searches the rest; results merge on device.

    ``fused=True`` (requires ``centroids`` [Nc, d] fp32 on the pool's
    device) runs the device partition as ONE ``probe_topk_fused`` launch
    over the pool's resident pages: the centroid probe, top-nprobe
    cluster admission and masked document top-k all happen in the
    kernel via the device page table (``page_cluster``).  Hits and
    misses are then the admitted clusters that are and are not
    resident, read from the kernel's own admitted mask: the host probe
    sums in another fp32 order, and at a near-tie of the nprobe-th
    centroid its ``probed_clusters`` may name another cluster than the
    kernel admitted.  On tie-free scores the two sets are equal, and the
    lists keep ``probed_clusters``' order (any cluster admitted beyond
    it follows, by id).  So the host search over ``probed_clusters``'
    misses and the merge are queued while the kernel runs, and the mask
    is read after them; only where it admits other misses is the host
    search run again.

    Otherwise the device partition is the reference's two-launch path: a
    per-query [B, num_pages] page mask built on the host from the slot
    table and the hit lists, uploaded, then ``ivf_topk`` over the slab.
    """
    B, nprobe = probed_clusters.shape
    buffer.flush_invalidations()
    resident = buffer.resident_clusters()
    dev = buffer.pool.device
    if dev.type == "cuda":
        buffer.wait_copies()                   # device-side wait, no host sync
    qd = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    pages, page_ids, page_cluster = buffer.device_view()
    hit = [[int(c) for c in row if int(c) in resident]
           for row in probed_clusters]
    miss = [[int(c) for c in row if int(c) not in resident]
            for row in probed_clusters]
    if fused and centroids is not None:
        Nc = centroids.shape[0]
        valid = torch.ones((Nc,), dtype=torch.bool, device=dev)
        dev_s, dev_i, admit = probe_topk.probe_topk_fused(
            qd, centroids, valid, pages, page_ids, page_cluster,
            nprobe=max(1, min(nprobe, Nc)), k=k)
        fs, fi = _host_merge(buffer, queries, miss, dev_s, dev_i, k)
        admitted = admit.cpu().numpy()         # [B, Nc], the one host read
        probed_miss, hit, miss = miss, [], []
        for b in range(B):
            ranked = [int(c) for c in probed_clusters[b]]
            extra = sorted(set(np.flatnonzero(admitted[b]).tolist())
                           - set(ranked))
            cs = [c for c in ranked if admitted[b, c]] + extra
            hit.append([c for c in cs if c in resident])
            miss.append([c for c in cs if c not in resident])
        if miss != probed_miss:                # a near-tie moved a miss
            fs, fi = _host_merge(buffer, queries, miss, dev_s, dev_i, k)
    else:
        # per-query page mask from the host mirror of the slot table
        # (exact per-query IVF nprobe semantics; page-level, so the
        # upload is num_pages bytes per query)
        luts = np.zeros((B, buffer.paged.num_clusters), bool)
        for b in range(B):
            luts[b, hit[b]] = True
        pc = buffer.slot_cluster
        page_mask = np.zeros((B, buffer.num_pages), bool)
        valid_slots = pc >= 0
        page_mask[:, valid_slots] = luts[:, pc[valid_slots]]
        dev_s, dev_i = ops.ivf_topk(pages, page_ids,
                                    torch.from_numpy(page_mask).to(dev), qd, k)
        fs, fi = _host_merge(buffer, queries, miss, dev_s, dev_i, k)
    return RetrievalResult(doc_ids=fi.cpu().numpy(), scores=fs.cpu().numpy(),
                           hit_clusters=hit, missed_clusters=miss,
                           nprobe=nprobe)


# ---------------------------------------------------------------------------
# Beyond-paper: datastore-sharded distributed search (paper §7)
# ---------------------------------------------------------------------------


def page_shard(num_pages: int, group: Optional[dist.ProcessGroup] = None,
               ) -> slice:
    """This rank's pages of a slab of ``num_pages`` sharded over
    ``group``: the rank-th contiguous 1/W of the page dim, as the
    reference's ``P(axis)`` slices it.  A count W does not divide is
    refused, as the reference's ``shard_map`` refuses it."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if num_pages % world:
        raise ValueError(f"{num_pages} pages do not shard over {world} ranks")
    n = num_pages // world
    return slice(rank * n, (rank + 1) * n)


def _all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup],
                ) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order [W, ...], on ``t``'s
    device.  gloo all-gathers host tensors only, so a CUDA tensor
    crosses through the host there."""
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.cpu() if host else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def sharded_device_search(queries: torch.Tensor, pages: torch.Tensor,
                          page_ids: torch.Tensor, page_mask: torch.Tensor, *,
                          k: int, group: Optional[dist.ProcessGroup] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a slab sharded over the ranks of ``group`` (the
    reference's ``sharded_device_search``): ``pages`` [P/W, ps, d],
    ``page_ids`` [P/W, ps] and ``page_mask`` [P/W] are this rank's block
    (``page_shard``), ``queries`` [B, d] the same on every rank.

    Each rank searches its block (``ops.ivf_topk``: kernel 3 on a CUDA
    tensor), the ranks all-gather the [B, k] scores and ids in rank
    order, and each takes the top k of the [B, W*k] candidates, ties to
    the lower position (a stable sort, as ``lax.top_k`` over the tiled
    gather).  Returns (scores [B, k] fp32, doc ids [B, k] int32), the
    same on every rank.  The exchange moves 8 * B * k bytes a rank:
    candidates, never vectors."""
    if page_mask.dim() != 1:
        raise ValueError("sharded_device_search takes a [P] page mask: the "
                         "reference's P(axis) would shard a [B, P] mask's "
                         "batch dim")
    s, i = ops.ivf_topk(pages, page_ids, page_mask, queries, k)
    # one exchange: the ids' bits ride beside the scores
    both = _all_gather(torch.cat([s, i.view(torch.float32)], dim=-1), group)
    B = queries.shape[0]
    s_all = both[..., :k].transpose(0, 1).reshape(B, -1)       # [B, W*k]
    i_all = both[..., k:].transpose(0, 1).reshape(B, -1).view(torch.int32)
    top_s, idx = torch.sort(s_all, dim=-1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(i_all, -1, idx[:, :k])
