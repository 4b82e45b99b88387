"""Public kernel entry points with the reference's signatures (minus
``mode=``).

There is no mode switch: each call goes by its tensors' device.  CPU
tensors run the plain PyTorch versions; CUDA tensors launch the
hand-written kernels or raise; meta tensors, on the three decode
wrappers a dry run traces, launch nothing and report their work.  Launch counts live on the wrappers,
and each adds to its count only where it launches on the card:
``flash_decode.launches``, ``flash_decode_quant.launches``,
``flash_decode_paged.launches``, ``flash_decode_spliced.launches``,
``mla_decode.launches`` and ``centroid_scores.launches``
count calls, each one grid launch (the decode kernels combine their
splits inside it);
``probe_topk_fused.launches`` and
``ivf_topk.launches`` count calls, each two grid launches (probe, then
page search and merge) and one (page search and merge).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import centroid_probe as _cprobe
from repro_torch.kernels import flash_decode as _flash
from repro_torch.kernels import ivf_topk as _ivf
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import probe_topk as _probe


def ivf_topk(pages: torch.Tensor, page_ids: torch.Tensor,
             page_mask: torch.Tensor, queries: torch.Tensor, k: int,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the pool's pages in place. pages [P,ps,d]; page_mask [P]
    or per-query [B,P]; queries [B,d] -> (scores [B,k], ids [B,k])."""
    return _ivf.ivf_topk(pages, page_ids, page_mask, queries, k)


def centroid_probe(centroids: torch.Tensor, queries: torch.Tensor,
                   nprobe: int, *, valid: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse probe -> (scores [B,nprobe], cluster ids [B,nprobe]): the
    masked centroid scores (kernel) then ``torch.topk``, as the reference
    is its kernel then ``lax.top_k``.  Ties at the cut are broken by
    ``torch.topk``, not by index as ``lax.top_k`` does: compare on
    tie-free scores, with nprobe below the valid count."""
    s = _cprobe.centroid_scores(queries, centroids, valid)
    return torch.topk(s, nprobe, dim=-1)


def probe_and_topk(queries: torch.Tensor, centroids: torch.Tensor,
                   pages: torch.Tensor, page_ids: torch.Tensor,
                   page_cluster: torch.Tensor, *, nprobe: int, k: int,
                   valid: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused retrieval over resident pool pages: centroid probe +
    top-nprobe cluster admission + masked top-k, reading the pool's
    ``device_view`` (pages [P,ps,d], page_ids [P,ps], page_cluster [P])
    in place.  Returns (scores [B,k] fp32, doc ids [B,k] int32)."""
    Nc = centroids.shape[0]
    nprobe = max(1, min(nprobe, Nc))
    if valid is None:
        valid = torch.ones((Nc,), dtype=torch.bool, device=centroids.device)
    s, i, _ = _probe.probe_topk_fused(queries, centroids, valid, pages,
                                      page_ids, page_cluster, nprobe=nprobe,
                                      k=k)
    return s, i


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """Decode attention [B,KVH,G,Dh] fp32 over dense KV [B,S,KVH,Dh] with
    per-row positions ``pos`` [B] int32 (``window`` > 0: sliding;
    ``softcap`` > 0: scores capped at ``softcap * tanh(s / softcap)``)."""
    return _flash.flash_decode(q, k, v, pos, window=window, softcap=softcap)


def flash_decode_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       pos: torch.Tensor, *, window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """``flash_decode`` over int8 KV [B,S,KVH,Dh] with bf16 scales
    [B,S,KVH], each row dequantized as ``dequantize_heads`` does; the
    reference dequantizes the whole cache in jnp instead (no Pallas
    kernel), the port reads it once at a byte an element."""
    return _flash.flash_decode_quant(q, k, v, k_scale, v_scale, pos,
                                     window=window, softcap=softcap)


def mla_decode(q_abs: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
               kpe: torch.Tensor, pos: torch.Tensor, scale: float,
               ) -> torch.Tensor:
    """Absorbed MLA attention over the latent cache: the weighted latent
    [B,H,R] fp32 of ``q_abs`` [B,H,R] and ``q_pe`` [B,H,Dr] against ckv
    [B,S,R] and kpe [B,S,Dr] at positions <= ``pos``.  The reference
    attends in jnp here (no Pallas kernel); the port's kernel reads each
    latent row once for all heads."""
    return _mla.mla_decode(q_abs, q_pe, ckv, kpe, pos, scale)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0,
                       ) -> torch.Tensor:
    """Decode attention [B,KVH,G,Dh] fp32 over paged KV [NP,ps,KVH,Dh]
    gathered through ``block_table`` [B,max_blocks] (-1 = unallocated)
    with per-request ``lengths`` [B]."""
    return _flash.flash_decode_paged(q, k_pages, v_pages, block_table,
                                     lengths, window=window)


def flash_decode_spliced(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, page_delta: torch.Tensor,
                         page_valid: torch.Tensor, *,
                         rope_fraction: float = 1.0,
                         rope_theta: float = 10_000.0) -> torch.Tensor:
    """Paged decode attention over a block table mixing fresh pages with
    spliced chunk-KV pages: each page's K rotated by ``page_delta``
    [B,MB] (the constant RoPE offset per page), dead slots masked by
    ``page_valid`` [B,MB] (live tokens per page).  The reference has no
    Pallas kernel for it (every mode runs its jnp oracle); the port's
    CUDA kernel is ``flash_decode_paged``'s with those two changes."""
    return _flash.flash_decode_spliced(
        q, k_pages, v_pages, block_table, lengths, page_delta, page_valid,
        rope_fraction=rope_fraction, rope_theta=rope_theta)
