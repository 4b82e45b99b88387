"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each function computes exactly what its JAX counterpart in the reference
package's ``kernels/ref.py`` computes, in the same layouts, so the CPU
tests can hold one against the other and ``chip_smoke.py`` can hold each
CUDA kernel against its plain version on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def ivf_topk_ref(pages: torch.Tensor, page_ids: torch.Tensor,
                 page_mask: torch.Tensor, queries: torch.Tensor, k: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked inner-product top-k over the prefetch slab.

    pages: [P, ps, d]; page_ids: [P, ps] (-1 = padding); page_mask: [P] or
    per-query [B, P] bool (clusters allowed for each query); queries [B, d].
    Returns (scores [B, k] fp32 desc, doc_ids [B, k] int32, -1 when empty).
    """
    P, ps, d = pages.shape
    flat = pages.reshape(P * ps, d).float()
    ids = page_ids.reshape(P * ps)
    if page_mask.dim() == 1:
        page_mask = page_mask[None, :]
    vmask = page_mask.repeat_interleave(ps, dim=1) & (ids >= 0)[None, :]
    scores = queries.float() @ flat.T                          # [B, P*ps]
    scores = scores.masked_fill(~vmask, float("-inf"))
    top_s, top_i = torch.topk(scores, k, dim=-1)
    top_ids = torch.where(torch.isfinite(top_s), ids[top_i],
                          torch.full_like(ids[top_i], -1))
    return top_s, top_ids.to(torch.int32)


def centroid_probe_ref(centroids: torch.Tensor, queries: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked centroid scores. centroids [Nc, d]; queries [B, d] -> [B, Nc]."""
    s = queries.float() @ centroids.float().T
    if valid is not None:
        s = s.masked_fill(~valid[None, :], float("-inf"))
    return s


def probe_and_topk_ref(queries: torch.Tensor, centroids: torch.Tensor,
                       valid: torch.Tensor, pages: torch.Tensor,
                       page_ids: torch.Tensor, page_cluster: torch.Tensor,
                       nprobe: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-retrieval plain version: centroid probe -> top-nprobe cluster
    set -> per-query page mask over the pool slab -> masked top-k.

    queries [B, d]; centroids [Nc, d]; valid [Nc] bool; pages [P, ps, d];
    page_ids [P, ps]; page_cluster [P] (-1 = unsearchable slot).
    Returns (scores [B, k] fp32, doc ids [B, k] int32).  Ties at the
    nprobe-th centroid score are broken by ``torch.topk`` (the kernel
    admits every tied cluster): compare the two on tie-free inputs.
    """
    B = queries.shape[0]
    Nc = centroids.shape[0]
    s = centroid_probe_ref(centroids, queries, valid)          # [B, Nc]
    top_s, top_i = torch.topk(s, min(nprobe, Nc), dim=-1)
    lut = torch.zeros((B, Nc), dtype=torch.bool, device=s.device)
    lut.scatter_(1, top_i, torch.isfinite(top_s))
    pc = page_cluster.long()
    page_mask = (pc >= 0)[None, :] & lut[:, pc.clamp(min=0)]   # [B, P]
    return ivf_topk_ref(pages, page_ids, page_mask, queries, k)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-token decode attention.

    q: [B, KVH, G, Dh]; k,v: [B, S, KVH, Dh]; pos: [B] (index of the new
    token; positions > pos are masked). window > 0 = sliding window.
    Returns [B, KVH, G, Dh] fp32.
    """
    B, S, KVH, Dh = k.shape
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    kp = torch.arange(S, dtype=torch.int32, device=k.device)[None, None, None, :]
    qp = pos.to(torch.int32)[:, None, None, None]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def flash_decode_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Paged decode attention: gather the block table into a dense cache,
    then run ``flash_decode_ref`` with ``pos = lengths - 1`` (lengths must
    be >= 1; -1 table entries are unallocated tail blocks, masked out by
    the position test either way).

    q [B, KVH, G, Dh]; k_pages, v_pages [NP, ps, KVH, Dh]; block_table
    [B, MB] int32; lengths [B] int32.  Returns [B, KVH, G, Dh] fp32.
    """
    B, MB = block_table.shape
    NP, ps, KVH, Dh = k_pages.shape
    bt = block_table.long().clamp(min=0)
    k = k_pages[bt].reshape(B, MB * ps, KVH, Dh)
    v = v_pages[bt].reshape(B, MB * ps, KVH, Dh)
    return flash_decode_ref(q, k, v, lengths - 1, window)
