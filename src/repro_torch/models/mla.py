"""Multi-head latent attention (DeepSeek-V2 / MiniCPM3): the counterpart
of the reference's ``models/mla.py``.

Prefill uses the expanded formulation; decode the *absorbed* one, which
caches only the compressed latent ``c_kv`` (kv_lora_rank R) and the
shared rotary key ``k_pe`` (qk_rope_head_dim Dr) per token.  Absorbed
decode, per head h:

  score(t) = (W_uk_h^T q_nope_h) . c_t + q_pe_h . k_pe_t
  out_h    = W_uv_h^T (sum_t p_t c_t)

The absorption ``q_abs = W_uk^T q_nope`` and the expansion through
``W_uv`` are plain products (``torch.einsum``); the attention over the
latent cache runs ``kernels.ops.mla_decode``, all fp32 as the
reference's.  Layer parameters are the reference's names in a flat
per-layer dict: ``w_dq`` [d, Rq], ``q_norm`` [Rq], ``w_uq`` [Rq, H, qk],
``w_dkv`` [d, R + Dr], ``kv_norm`` [R], ``w_uk`` [R, H, nope], ``w_uv``
[R, H, v] and ``wo`` [H, v, d].
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope, chunked_attention, rms_norm

PARAMS = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv")
# each parameter's logical axes in the reference's mla_params (one layer;
# ``wo`` is the attention's)
AXES = {"w_dq": ("embed", None), "q_norm": (None,),
        "w_uq": (None, "heads", None), "w_dkv": ("embed", None),
        "kv_norm": (None,), "w_uk": (None, "heads", None),
        "w_uv": (None, "heads", None)}


def mla_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's MLA parameters (``wo`` included), as the reference's
    ``mla_params`` shapes them."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"w_dq": (d, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
            "w_uq": (m.q_lora_rank, H, qk),
            "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm": (m.kv_lora_rank,),
            "w_uk": (m.kv_lora_rank, H, m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, H, m.v_head_dim),
            "wo": (H, m.v_head_dim, d)}


def _latents(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor):
    """(q_nope [B, S, H, nope], q_pe [B, S, H, Dr] rotated, c_kv [B, S, R]
    normed, k_pe [B, S, Dr] rotated) of x [B, S, d] at ``positions``
    (broadcastable to [B, S])."""
    m = cfg.mla
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_pe = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                      theta=cfg.rope_theta)
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(dkv[..., None, m.kv_lora_rank:], positions,
                      theta=cfg.rope_theta)
    return q_nope, q_pe, c_kv, k_pe[..., 0, :]


def mla_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                *, positions: torch.Tensor, attn_chunk: int = 1024,
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Expanded MLA for prefill: x [B, S, d] at positions [S].  Returns
    (out [B, S, d], (c_kv [B, S, R], k_pe [B, S, Dr]) for the cache), as
    the reference's ``mla_forward`` (values padded to the qk width so the
    shared ``chunked_attention`` scores at 1/sqrt(qk))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_pe, c_kv, k_pe = _latents(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    v_pad = F.pad(v, (0, qk - m.v_head_dim))
    out = chunked_attention(q_full.reshape(B, S, H, 1, qk), k_full, v_pad,
                            q_positions=positions, kv_positions=positions,
                            softcap_val=cfg.attn_logit_softcap,
                            chunk=min(attn_chunk, S))
    out = out.reshape(B, S, H, qk)[..., :m.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (c_kv, k_pe)


def mla_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
               cache_ckv: torch.Tensor, cache_kpe: torch.Tensor,
               pos: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
               ) -> torch.Tensor:
    """Absorbed one-token decode.  x [B, d]; cache_ckv [B, S, R] and
    cache_kpe [B, S, Dr], updated in place at (``rows``, ``at``) (pos
    clipped to the cache, made once per step by the caller); attends
    over positions <= ``pos`` with ``kernels.ops.mla_decode``.  Returns
    [B, d] in x's dtype."""
    m = cfg.mla
    q_nope, q_pe, c_new, kpe_new = _latents(p, x[:, None], cfg, pos[:, None])
    cache_ckv[rows, at] = c_new[:, 0].to(cache_ckv.dtype)
    cache_kpe[rows, at] = kpe_new[:, 0].to(cache_kpe.dtype)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])   # [B, H, R]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    latent = kernel_ops.mla_decode(q_abs.float().contiguous(),
                                   q_pe[:, 0].float().contiguous(),
                                   cache_ckv, cache_kpe, pos, scale)
    out = torch.einsum("bhr,rhk->bhk", latent, p["w_uv"].float()).to(x.dtype)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])
