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

from repro_torch.models.layers import apply_rope


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
                       nprobe: int, k: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-retrieval plain version: centroid probe -> top-nprobe cluster
    set -> per-query page mask over the pool slab -> masked top-k.

    queries [B, d]; centroids [Nc, d]; valid [Nc] bool; pages [P, ps, d];
    page_ids [P, ps]; page_cluster [P] (-1 = unsearchable slot).
    Returns (scores [B, k] fp32, doc ids [B, k] int32, admitted [B, Nc]
    bool, the cluster set ``torch.topk`` chose).  Ties at the nprobe-th
    centroid score are broken by ``torch.topk`` (the kernel admits every
    tied cluster): compare the two on tie-free inputs.
    """
    B = queries.shape[0]
    Nc = centroids.shape[0]
    s = centroid_probe_ref(centroids, queries, valid)          # [B, Nc]
    top_s, top_i = torch.topk(s, min(nprobe, Nc), dim=-1)
    lut = torch.zeros((B, Nc), dtype=torch.bool, device=s.device)
    lut.scatter_(1, top_i, torch.isfinite(top_s))
    pc = page_cluster.long()
    page_mask = (pc >= 0)[None, :] & lut[:, pc.clamp(min=0)]   # [B, P]
    return (*ivf_topk_ref(pages, page_ids, page_mask, queries, k), lut)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention.

    q: [B, KVH, G, Dh]; k,v: [B, S, KVH, Dh]; pos: [B] (index of the new
    token; positions > pos are masked). window > 0 = sliding window;
    softcap > 0 caps each scaled fp32 score at ``softcap * tanh(s /
    softcap)`` before the mask and the max, as the reference's
    ``_decode_attention`` does (``models/attention.py``).
    Returns [B, KVH, G, Dh] fp32.
    """
    B, S, KVH, Dh = k.shape
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(S, dtype=torch.int32, device=k.device)[None, None, None, :]
    qp = pos.to(torch.int32)[:, None, None, None]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def dequantize_ref(x: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 values [..., Dh] times their scales [...]: the product in
    fp32, as ``dtype`` (bf16 by default), as the reference's
    ``dequantize_heads``."""
    return (x.float() * scale.float()[..., None]).to(dtype)


def flash_decode_quant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           pos: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """``flash_decode_ref`` over an int8 cache: k, v int8 [B, S, KVH, Dh]
    with per-(token, head) bf16 scales [B, S, KVH], each row dequantized
    by ``dequantize_ref`` first.  Returns [B, KVH, G, Dh] fp32."""
    return flash_decode_ref(q, dequantize_ref(k, k_scale),
                            dequantize_ref(v, v_scale), pos, window, softcap)


def mla_decode_ref(q_abs: torch.Tensor, q_pe: torch.Tensor,
                   ckv: torch.Tensor, kpe: torch.Tensor, pos: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Absorbed multi-head latent attention for one new token, all fp32,
    as the reference's ``mla_decode`` computes it (``models/mla.py``):
    scores ``(q_abs . ckv_t + q_pe . kpe_t) * scale`` over ``t <= pos``,
    softmax, then the probabilities times the latent rows.

    q_abs [B, H, R], q_pe [B, H, Dr]; ckv [B, S, R], kpe [B, S, Dr];
    pos [B].  Returns the attention-weighted latent [B, H, R] fp32.
    """
    S = ckv.shape[1]
    c = ckv.float()
    s = (torch.einsum("bhr,btr->bht", q_abs.float(), c)
         + torch.einsum("bhk,btk->bht", q_pe.float(), kpe.float())) * scale
    t = torch.arange(S, device=ckv.device)[None, None, :]
    s = s.masked_fill(t > pos.long()[:, None, None], float("-inf"))
    return torch.einsum("bht,btr->bhr", torch.softmax(s, dim=-1), c)


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


def flash_decode_spliced_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_table: torch.Tensor,
                             lengths: torch.Tensor, page_delta: torch.Tensor,
                             page_valid: torch.Tensor, *,
                             rope_fraction: float = 1.0,
                             rope_theta: float = 10_000.0) -> torch.Tensor:
    """Paged decode attention over a block table that mixes fresh pages
    with **spliced** chunk-KV pages (reordered RoPE, TurboRAG).

    Spliced pages hold K rotated at chunk-local positions; rotations
    compose, so rotating a page's stored K by its constant layout offset
    ``page_delta[b, blk]`` reindexes it to the wave's positions (the
    rotated K is rounded back to the page dtype, as ``apply_rope``
    returns).  ``page_valid[b, blk]`` live tokens per page (< ps only on a
    chunk's partial last page; 0 on -1 columns): dead slots are masked.
    Fresh pages carry delta 0 and valid ps.

    q [B, KVH, G, Dh]; k_pages, v_pages [NP, ps, KVH, Dh]; block_table,
    page_delta, page_valid [B, MB] int32; lengths [B] int32 (the new
    token at layout position ``lengths - 1``).  Returns [B, KVH, G, Dh]
    fp32.
    """
    B, MB = block_table.shape
    NP, ps, KVH, Dh = k_pages.shape
    bt = block_table.long().clamp(min=0)
    k = k_pages[bt]                                    # [B, MB, ps, KVH, Dh]
    v = v_pages[bt]
    k = apply_rope(k, page_delta[:, :, None].expand(B, MB, ps),
                   fraction=rope_fraction, theta=rope_theta)
    k = k.reshape(B, MB * ps, KVH, Dh)
    v = v.reshape(B, MB * ps, KVH, Dh)
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    kp = torch.arange(MB * ps, dtype=torch.int32, device=k.device)
    live = (kp[None, :] % ps) < page_valid.repeat_interleave(ps, dim=1)
    causal = kp[None, :] <= (lengths.to(torch.int32) - 1)[:, None]
    mask = (live & causal)[:, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())
