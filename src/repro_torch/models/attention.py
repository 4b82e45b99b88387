"""Grouped-query attention, full-sequence (prefill) and for one new
decode token over dense, ring, int8 or paged KV: the counterpart of the
reference's ``models/attention.py``.

``attn_forward`` projects a whole sequence, rotates q and k at their
positions and attends causally (within a sliding ``window`` where one is
given, scores softcapped at ``cfg.attn_logit_softcap``) with
``layers.chunked_attention``, returning the rotated K and V for the
cache.  The decode forms project q/k/v from the layer input, rotate q and k at the new
token's position, write the new K/V into the cache in place before
attending (so the token attends to itself), attend with a hand-written
kernel and project back through ``wo``.  The head counts are the
weights' (``wq``'s, ``wk``'s and ``wo``'s head dims):

  * ``attn_decode``: dense cache [B, S, KVH, Dh], the token at ``pos``,
    ``kernels.ops.flash_decode`` (the reference's ``attn_decode``), an
    optional sliding window, the config's score softcap;
  * ``attn_decode_ring``: a ring of W slots [B, W, KVH, Dh] (gemma2's
    local layers), the token at slot ``pos % W``; the ring holds exactly
    the last W positions, so ``flash_decode`` over its first
    ``min(pos, W - 1) + 1`` slots is the reference's ring mask (K is
    rotated when written, and softmax does not depend on slot order);
  * ``attn_decode_quant``: an int8 cache with per-(token, head) bf16
    scales (``quantize_heads``), ``kernels.ops.flash_decode_quant``, which
    dequantizes each row as ``dequantize_heads`` does;
  * ``attn_decode_paged``: block-table pages [NP, ps, KVH, Dh], the
    token at ``lengths``, ``kernels.ops.flash_decode_paged``;
  * ``attn_decode_spliced``: the same pages with spliced chunk-KV pages
    in the table, ``kernels.ops.flash_decode_spliced`` (each page's K
    rotated by its ``page_delta``, dead tails masked by ``page_valid``).

The caches are updated in place (the reference returns new ones).  The
kernels compute both products in fp32 from fp32 q (the reference's
``_decode_attention`` casts the scaled q and the probabilities to the
cache dtype first, and its int8 path to bf16 whatever the model's
dtype), so in bf16 the two agree within a tolerance only.

Each form also runs on one rank of a tensor-parallel group (``tp``, a
``tensor_parallel.TPRank``): the layer's weights are the rank's blocks,
so the head counts are the weights' (``H / model`` query heads, ``KVH /
model`` KV heads, or all of them where a count does not split), the
kernels run at those counts, and the row-parallel ``wo`` product is
all-reduced where the heads split.  Where the query heads split but the
KV heads do not (and are more than one), the rank's queries go into a
zeroed global [KVH, G] layout (``group_heads``) and its rows come back
out (``ungroup_heads``).  Not ported: sequence-parallel decode
(``kv_seq_spec``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
# the reference's name for the plain dequantization the int8 kernel repeats
from repro_torch.kernels.ref import dequantize_ref as dequantize_heads  # noqa: F401
from repro_torch.models.layers import apply_rope, chunked_attention

if TYPE_CHECKING:
    from repro_torch.distributed.tensor_parallel import TPRank


def group_heads(q: torch.Tensor, kvh: int, tp: Optional["TPRank"]
                ) -> torch.Tensor:
    """q [..., H', Dh] -> [..., KVH', G', Dh], query head h in group h //
    G' of the ``kvh`` KV heads; on a rank whose query heads split while
    its ``kvh`` KV heads are whole (``TPLayout.padded_heads``), its heads
    placed at their global positions among zeros: [..., KVH, H / KVH,
    Dh]."""
    H, Dh = q.shape[-2:]
    if tp is None or not tp.layout.padded_heads:
        return q.reshape(q.shape[:-2] + (kvh, H // kvh, Dh))
    lo, hi = tp.layout.heads
    full = q.new_zeros(q.shape[:-2] + (H * tp.layout.size, Dh))
    full[..., lo:hi, :] = q
    return full.reshape(q.shape[:-2] + (kvh, H * tp.layout.size // kvh, Dh))


def ungroup_heads(out: torch.Tensor, tp: Optional["TPRank"]) -> torch.Tensor:
    """``group_heads``' inverse: [..., KVH', G', Dh] -> the rank's [...,
    H', Dh]."""
    flat = out.reshape(out.shape[:-3] + (-1, out.shape[-1]))
    if tp is None or not tp.layout.padded_heads:
        return flat
    lo, hi = tp.layout.heads
    return flat[..., lo:hi, :]


def attn_forward(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ArchConfig, *, positions: torch.Tensor,
                 window: Optional[int] = None, attn_chunk: int = 1024,
                 tp: Optional["TPRank"] = None,
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention (prefill).  x [B, S, d]; positions
    [S] int32; ``window`` W > 0 attends to the last W positions only.
    Returns (out [B, S, d], (k, v) [B, S, KVH, Dh] for the cache, k
    rotated), as the reference's ``attn_forward``; on a rank (``tp``)
    its heads' K/V, ``wo``'s product all-reduced where the heads split.
    With gradients on, x enters the split projections through
    Megatron's "f" (``TPRank.copy``); where the query heads split and
    the KV heads do not (MQA, the padded layout), x enters the whole
    K/V projections as it is and the whole K and V get the "f" instead,
    so ``wk`` and ``wv`` take the gradient of every rank's heads."""
    B, S, _ = x.shape
    H, KVH, Dh = layer["wq"].shape[-2], layer["wk"].shape[-2], \
        cfg.resolved_head_dim
    heads = tp is not None and tp.layout.heads is not None
    kv_split = tp is not None and tp.layout.kv_heads is not None
    xq = tp.copy(x, heads) if tp is not None else x
    xkv = xq if kv_split else x
    q = torch.einsum("bsd,dhk->bshk", xq, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, layer["wv"])
    if heads and not kv_split:      # whole K/V enter the split attention
        k, v = tp.copy(k), tp.copy(v)
    q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    out = chunked_attention(group_heads(q, KVH, tp), k, v,
                            q_positions=positions, kv_positions=positions,
                            window=window, softcap_val=cfg.attn_logit_softcap,
                            chunk=min(attn_chunk, S))
    out = ungroup_heads(out, tp)
    out = torch.einsum("bshk,hkd->bsd", out, layer["wo"])
    if tp is not None:
        out = tp.reduce(out, tp.layout.heads)
    return out, (k, v)


def project_qkv(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, positions: torch.Tensor,
                tp: Optional["TPRank"] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, d] at positions [B, 1] -> q [B, KVH, G, Dh] and k, v
    [B, KVH, Dh], q and k rotated; on a rank (``tp``) the counts of its
    weights' heads, q grouped by ``group_heads``."""
    B = x.shape[0]
    H, KVH, Dh = layer["wq"].shape[-2], layer["wk"].shape[-2], \
        cfg.resolved_head_dim
    q = (x @ layer["wq"].reshape(cfg.d_model, H * Dh)).reshape(B, 1, H, Dh)
    k = (x @ layer["wk"].reshape(cfg.d_model, KVH * Dh)).reshape(B, 1, KVH, Dh)
    v = (x @ layer["wv"].reshape(cfg.d_model, KVH * Dh)).reshape(B, KVH, Dh)
    q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    return group_heads(q[:, 0], KVH, tp).contiguous(), k[:, 0], v


def out_proj(layer: Dict[str, torch.Tensor], out: torch.Tensor,
             cfg: ArchConfig, dtype: torch.dtype,
             tp: Optional["TPRank"] = None) -> torch.Tensor:
    """Attention output [B, KVH, G, Dh] (fp32) -> [B, d] in ``dtype``; on
    a rank (``tp``) its heads' rows through its ``wo`` block, all-reduced
    where the heads split."""
    B = out.shape[0]
    H, Dh = layer["wo"].shape[0], cfg.resolved_head_dim
    out = ungroup_heads(out, tp).reshape(B, H * Dh).to(dtype) \
        @ layer["wo"].reshape(H * Dh, cfg.d_model)
    if tp is not None:
        out = tp.reduce(out, tp.layout.heads)
    return out


def _softcap(cfg: ArchConfig) -> float:
    """The kernels' softcap argument: the config's, 0 for none."""
    return float(cfg.attn_logit_softcap or 0.0)


def attn_decode(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                window: int = 0, tp: Optional["TPRank"] = None) -> torch.Tensor:
    """One-token decode over a dense cache.  x [B, d]; cache_k/v
    [B, S, KVH, Dh], updated in place at (``rows``, ``at``): arange(B)
    and ``pos`` [B] int32 clipped to the cache, as the reference's
    ``dynamic_update_slice`` clips (made once per step by the caller);
    ``window`` W > 0 attends to the last W positions.  Returns the
    attention output [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, pos[:, None], tp)
    cache_k[rows, at] = k.to(cache_k.dtype)
    cache_v[rows, at] = v.to(cache_v.dtype)
    out = kernel_ops.flash_decode(q, cache_k, cache_v, pos, window=window,
                                  softcap=_softcap(cfg))
    return out_proj(layer, out, cfg, x.dtype, tp)


def quantize_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization over the head dim, as
    the reference's: x [..., Dh] -> (int8 [..., Dh], bf16 scale [...]),
    scale = max(|x|) / 127 (at least 1e-8) in fp32, values rounded half
    to even and clipped to [-127, 127]."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def attn_decode_quant(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: ArchConfig, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, pos: torch.Tensor,
                      rows: torch.Tensor, at: torch.Tensor,
                      window: int = 0, tp: Optional["TPRank"] = None,
                      ) -> torch.Tensor:
    """``attn_decode`` over an int8 cache: cache_k/v int8 [B, S, KVH, Dh]
    and k_scale/v_scale bf16 [B, S, KVH], the new token's K/V quantized
    (``quantize_heads``) and written in place at (``rows``, ``at``), then
    ``kernels.ops.flash_decode_quant`` (each row dequantized to bf16
    values, as the reference's ``attn_decode_quant`` dequantizes its
    cache).  Returns [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, pos[:, None], tp)
    kq, ks = quantize_heads(k)
    vq, vs = quantize_heads(v)
    cache_k[rows, at] = kq
    cache_v[rows, at] = vq
    k_scale[rows, at] = ks
    v_scale[rows, at] = vs
    out = kernel_ops.flash_decode_quant(q, cache_k, cache_v, k_scale, v_scale,
                                        pos, window=window,
                                        softcap=_softcap(cfg))
    return out_proj(layer, out, cfg, x.dtype, tp)


def attn_decode_ring(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ArchConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     rows: torch.Tensor, slot: torch.Tensor,
                     ring_pos: torch.Tensor) -> torch.Tensor:
    """Sliding-window decode over a RING of W slots (gemma2's local
    layers): cache_k/v [B, W, KVH, Dh], slot ``p % W`` holding the newest
    token at that residue, i.e. exactly the last W positions.  The new
    K/V (rotated at ``pos``) is written in place at (``rows``, ``slot``
    = pos % W), then ``flash_decode`` attends over slots <= ``ring_pos``
    = min(pos, W - 1) with no window: the reference's ring mask
    ``pos - ((pos - s) mod W) >= 0`` is exactly ``s <= min(pos, W -
    1)``, and softmax does not depend on the slots' order.  ``slot`` and
    ``ring_pos`` [B] are made once per step by the caller.  Returns [B,
    d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, pos[:, None])
    cache_k[rows, slot] = k.to(cache_k.dtype)
    cache_v[rows, slot] = v.to(cache_v.dtype)
    out = kernel_ops.flash_decode(q, cache_k, cache_v, ring_pos,
                                  softcap=_softcap(cfg))
    return out_proj(layer, out, cfg, x.dtype)


def ring_from_full(k_full: torch.Tensor, window: int) -> torch.Tensor:
    """Full-sequence K or V [..., S, KVH, Dh] (the sequence at dim -3) in
    the ring layout [..., window, KVH, Dh] (the prefill -> decode
    handoff): the last min(window, S) positions, position p at slot p %
    window (zero slots past S when S < window), as the reference's
    ``ring_from_full``."""
    S = k_full.shape[-3]
    W = min(window, S)
    last = k_full[..., S - W:, :, :]
    if W < window:
        pad = torch.zeros(last.shape[:-3] + (window - W,) + last.shape[-2:],
                          dtype=last.dtype, device=last.device)
        return torch.cat([last, pad], dim=-3)
    return torch.roll(last, shifts=(S - W) % W, dims=-3)


def attn_decode_paged(layer: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: ArchConfig, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor,
                      lengths: torch.Tensor, slot: torch.Tensor,
                      off: torch.Tensor, attn_len: torch.Tensor,
                      tp: Optional["TPRank"] = None) -> torch.Tensor:
    """One-token decode over block-table pages.  x [B, d]; k/v_pages
    [NP, ps, KVH, Dh], updated in place at (``slot``, ``off``), the page
    and offset of position ``lengths`` [B] int32; attends over
    ``attn_len`` = lengths + 1 tokens (int32, made once per step by the
    caller); returns [B, d] in x's dtype."""
    q, k, v = project_qkv(layer, x, cfg, lengths[:, None], tp)
    k_pages[slot, off] = k.to(k_pages.dtype)
    v_pages[slot, off] = v.to(v_pages.dtype)
    out = kernel_ops.flash_decode_paged(q, k_pages, v_pages, block_table,
                                        attn_len)
    return out_proj(layer, out, cfg, x.dtype, tp)


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
