"""Grouped-query attention, full-sequence (prefill) and for one new
decode token over dense or paged KV: the counterpart of the reference's
``models/attention.py`` for the plain global-causal GQA family
(``transformer.check_supported``).

``attn_forward`` projects a whole sequence, rotates q and k at their
positions and attends causally with ``layers.chunked_attention``,
returning the rotated K and V for the cache.  The decode forms project q/k/v from the layer input, rotate q and k at the new
token's position, write the new K/V into the cache in place before
attending (so the token attends to itself), attend with a hand-written
kernel and project back through ``wo``:

  * ``attn_decode``: dense cache [B, S, KVH, Dh], the token at ``pos``,
    ``kernels.ops.flash_decode`` (the reference's ``attn_decode``);
  * ``attn_decode_paged``: block-table pages [NP, ps, KVH, Dh], the
    token at ``lengths``, ``kernels.ops.flash_decode_paged``;
  * ``attn_decode_spliced``: the same pages with spliced chunk-KV pages
    in the table, ``kernels.ops.flash_decode_spliced`` (each page's K
    rotated by its ``page_delta``, dead tails masked by ``page_valid``).

The caches are updated in place (the reference returns new ones).  The
kernels compute both products in fp32 from fp32 q (the reference's
``_decode_attention`` casts the scaled q and the probabilities to the
cache dtype first), so in bf16 the two agree within a tolerance only.
Not ported, because no supported family needs them: sliding windows, int8 KV, the ring cache, MLA, logit softcap
and sequence-parallel decode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope, chunked_attention


def attn_forward(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ArchConfig, *, positions: torch.Tensor,
                 attn_chunk: int = 1024,
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention (prefill).  x [B, S, d]; positions
    [S] int32.  Returns (out [B, S, d], (k, v) [B, S, KVH, Dh] for the
    cache, k rotated), as the reference's ``attn_forward``."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, layer["wv"])
    q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    out = chunked_attention(q.reshape(B, S, KVH, H // KVH, Dh), k, v,
                            q_positions=positions, kv_positions=positions,
                            chunk=min(attn_chunk, S))
    out = out.reshape(B, S, H, Dh)
    return torch.einsum("bshk,hkd->bsd", out, layer["wo"]), (k, v)


def project_qkv(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, positions: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, d] at positions [B, 1] -> q [B, KVH, G, Dh] and k, v
    [B, KVH, Dh], q and k rotated."""
    B = x.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ layer["wq"].reshape(cfg.d_model, H * Dh)).reshape(B, 1, H, Dh)
    k = (x @ layer["wk"].reshape(cfg.d_model, KVH * Dh)).reshape(B, 1, KVH, Dh)
    v = (x @ layer["wv"].reshape(cfg.d_model, KVH * Dh)).reshape(B, KVH, Dh)
    q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    return q[:, 0].reshape(B, KVH, H // KVH, Dh).contiguous(), k[:, 0], v


def out_proj(layer: Dict[str, torch.Tensor], out: torch.Tensor,
             cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    """Attention output [B, KVH, G, Dh] (fp32) -> [B, d] in ``dtype``."""
    B = out.shape[0]
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    return out.reshape(B, H * Dh).to(dtype) @ layer["wo"].reshape(H * Dh,
                                                                  cfg.d_model)


def attn_decode(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                ) -> torch.Tensor:
    """One-token decode over a dense cache.  x [B, d]; cache_k/v
    [B, S, KVH, Dh], updated in place at (``rows``, ``at``): arange(B)
    and ``pos`` [B] int32 clipped to the cache, as the reference's
    ``dynamic_update_slice`` clips (made once per step by the caller);
    returns the attention output [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, pos[:, None])
    cache_k[rows, at] = k.to(cache_k.dtype)
    cache_v[rows, at] = v.to(cache_v.dtype)
    out = kernel_ops.flash_decode(q, cache_k, cache_v, pos)
    return out_proj(layer, out, cfg, x.dtype)


def attn_decode_paged(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: ArchConfig, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor,
                      lengths: torch.Tensor, slot: torch.Tensor,
                      off: torch.Tensor, attn_len: torch.Tensor) -> torch.Tensor:
    """One-token decode over block-table pages.  x [B, d]; k/v_pages
    [NP, ps, KVH, Dh], updated in place at (``slot``, ``off``), the page
    and offset of position ``lengths`` [B] int32; attends over
    ``attn_len`` = lengths + 1 tokens (int32, made once per step by the
    caller); returns [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, lengths[:, None])
    k_pages[slot, off] = k.to(k_pages.dtype)
    v_pages[slot, off] = v.to(v_pages.dtype)
    out = kernel_ops.flash_decode_paged(q, k_pages, v_pages, block_table,
                                        attn_len)
    return out_proj(layer, out, cfg, x.dtype)


def attn_decode_spliced(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                        cfg: ArchConfig, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, page_delta: torch.Tensor,
                        page_valid: torch.Tensor, slot: torch.Tensor,
                        off: torch.Tensor, attn_len: torch.Tensor,
                        ) -> torch.Tensor:
    """``attn_decode_paged`` over a table that holds spliced chunk-KV
    pages: the new token is rotated and written at layout position
    ``lengths`` as there, and attention runs through
    ``kernels.ops.flash_decode_spliced`` with the per-page ``page_delta``
    and ``page_valid`` [B, MB] int32.  Returns [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, lengths[:, None])
    k_pages[slot, off] = k.to(k_pages.dtype)
    v_pages[slot, off] = v.to(v_pages.dtype)
    out = kernel_ops.flash_decode_spliced(
        q, k_pages, v_pages, block_table, attn_len, page_delta, page_valid,
        rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta)
    return out_proj(layer, out, cfg, x.dtype)
