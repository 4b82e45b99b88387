"""Public kernel entry points with the reference's signatures (minus
``mode=``).

There is no mode switch: each call goes by its tensors' device.  CPU
tensors run the plain PyTorch versions; CUDA tensors launch the
hand-written kernels or raise.  Launch counts live on the wrappers:
``flash_decode_paged.launches`` and ``probe_topk_fused.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_decode as _flash
from repro_torch.kernels import probe_topk as _probe


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
    return _probe.probe_topk_fused(queries, centroids, valid, pages, page_ids,
                                   page_cluster, nprobe=nprobe, k=k)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0,
                       ) -> torch.Tensor:
    """Decode attention [B,KVH,G,Dh] fp32 over paged KV [NP,ps,KVH,Dh]
    gathered through ``block_table`` [B,max_blocks] (-1 = unallocated)
    with per-request ``lengths`` [B]."""
    return _flash.flash_decode_paged(q, k_pages, v_pages, block_table,
                                     lengths, window=window)
