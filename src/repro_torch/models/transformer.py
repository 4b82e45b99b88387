"""Plain global-causal GQA decoder (the Llama-3 family) as an ``nn.Module``.

Parameters are stacked along a leading layer dim, exactly like the
reference's pytree (``layers.attn.wq`` [L, d, H, Dh], ...), so
``from_jax_params`` carries a reference ``init_params`` tree across as
is.  The serving path is ``serve_step_paged``: one decode step over
block-table KV that writes the new token's K/V into the page slab (in
place) and attends with the ``flash_decode_paged`` kernel.  Prefill,
MoE, MLA, SSM and the dense ``serve_step`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope, mlp_forward, rms_norm, softcap

# flat parameter name -> its path in the reference pytree
_JAX_PATHS = {
    "embed": ("embed",), "unembed": ("unembed",),
    "final_norm": ("final_norm",),
    "attn_norm": ("layers", "attn_norm"),
    "wq": ("layers", "attn", "wq"), "wk": ("layers", "attn", "wk"),
    "wv": ("layers", "attn", "wv"), "wo": ("layers", "attn", "wo"),
    "mlp_norm": ("layers", "mlp_norm"),
    "w_up": ("layers", "mlp", "w_up"), "w_gate": ("layers", "mlp", "w_gate"),
    "w_down": ("layers", "mlp", "w_down"),
}
_LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_up",
                 "w_gate", "w_down")


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a plain global-causal GQA decoder with a
    gated MLP and separate unembedding (what this module implements)."""
    ok = (cfg.attn_kind == "gqa" and cfg.moe is None and cfg.ssm is None
          and cfg.frontend is None and not cfg.shared_attn_every
          and not cfg.sliding_window and not cfg.local_global_pattern
          and cfg.attn_logit_softcap is None and cfg.mlp_gated
          and not cfg.tie_embeddings)
    if not ok:
        raise ValueError(f"arch {cfg.name!r} is not a plain global-causal GQA "
                         "decoder; only that family is ported")


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of every parameter (layer params stacked along dim 0)."""
    d, L, V, F = cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.d_ff
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "embed": (V, d), "unembed": (d, V), "final_norm": (d,),
        "attn_norm": (L, d), "wq": (L, d, H, Dh), "wk": (L, d, KVH, Dh),
        "wv": (L, d, KVH, Dh), "wo": (L, H, Dh, d), "mlp_norm": (L, d),
        "w_up": (L, d, F), "w_gate": (L, d, F), "w_down": (L, F, d),
    }


class Transformer(nn.Module):
    """Decoder weights (no gradients) plus the paged decode step."""

    def __init__(self, cfg: ArchConfig, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        shapes = param_shapes(cfg)
        if set(tensors) != set(shapes):
            raise ValueError(f"want parameters {sorted(shapes)}, got "
                             f"{sorted(tensors)}")
        for name, t in tensors.items():
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                                 f"{shapes[name]}")
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l``'s parameters (views into the stacked tensors)."""
        return {name: getattr(self, name)[l] for name in _LAYER_PARAMS}

    def forward(self, k_slab, v_slab, block_table, lengths, tokens):
        """``serve_step_paged`` on this model."""
        return serve_step_paged(self, k_slab, v_slab, block_table, lengths,
                                {"token": tokens})


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Transformer:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): truncated normal in [-2, 2] scaled by 1/sqrt(fan_in)
    (fan_in = the per-layer shape's first dim, as the reference's
    ``InitMaker``), embedding scale 0.02, norms ones.  Layer tensors are
    filled one layer at a time, so the fp32 scratch stays one layer big."""
    dev = resolve_device(device)
    tensors: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=dev)
        if name.endswith("norm"):
            t.fill_(1.0)
        else:
            per = shape[1:] if name in _LAYER_PARAMS else shape
            scale = 0.02 if name == "embed" else 1.0 / math.sqrt(max(per[0], 1))
            for part in (t if name in _LAYER_PARAMS else [t]):
                tmp = torch.empty(per, dtype=torch.float32, device=dev)
                nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                part.copy_(tmp.mul_(scale))
        tensors[name] = t
    return Transformer(cfg, tensors)


def from_jax_params(np_tree: Mapping, cfg: ArchConfig,
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Transformer:
    """A reference ``init_params`` pytree (leaves as numpy arrays, layers
    stacked ``[L, ...]``) as a ``Transformer`` on ``device``; ``dtype``
    None keeps each array's own dtype."""
    dev = resolve_device(device)
    tensors = {}
    for name, path in _JAX_PATHS.items():
        node = np_tree
        for key in path:
            node = node[key]
        t = torch.from_numpy(np.array(node))       # own, writable copy
        tensors[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return Transformer(cfg, tensors)


def embed_tokens(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [...] -> embeddings [..., d]."""
    return model.embed[tokens.long()]


def unembed(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """x: [..., d] -> logits [..., V]."""
    return softcap(x @ model.unembed, model.cfg.final_logit_softcap)


def serve_step_paged(model: Transformer, k_slab: torch.Tensor,
                     v_slab: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, inputs: Dict[str, torch.Tensor],
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over **paged** (block-table) KV.

    k_slab/v_slab: the ``KVPageSlab`` tensors [L, NP, ps, KVH, Dh];
    block_table: [B, max_blocks] int32 slab page slots; lengths: [B]
    int32 tokens already written per sequence, on the model's device.
    The new token's K/V is written IN PLACE at position ``lengths``
    (``slot = block_table[b, lengths // ps]``, ``off = lengths % ps``)
    before attention runs over ``lengths + 1`` tokens with
    ``kernels.ops.flash_decode_paged``; the caller advances the lease's
    lengths afterwards.  inputs: token [B].

    Returns (logits [B, V], k_slab, v_slab) — the slabs are the same
    tensors, updated in place.
    """
    cfg = model.cfg
    tok = inputs["token"]
    h = embed_tokens(model, tok)                         # [B, d]
    B = h.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ps = k_slab.shape[2]
    positions = lengths[:, None]                         # new token's position
    lens = lengths.long()
    slot = block_table.long().gather(1, (lens // ps)[:, None])[:, 0]
    off = lens % ps
    attn_len = (lengths + 1).to(torch.int32)

    for l in range(cfg.num_layers):
        lp = model.layer(l)
        a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = (a_in @ lp["wq"].reshape(cfg.d_model, H * Dh)).reshape(B, 1, H, Dh)
        k = (a_in @ lp["wk"].reshape(cfg.d_model, KVH * Dh)).reshape(B, 1, KVH, Dh)
        v = (a_in @ lp["wv"].reshape(cfg.d_model, KVH * Dh)).reshape(B, KVH, Dh)
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        kl, vl = k_slab[l], v_slab[l]
        kl[slot, off] = k[:, 0].to(kl.dtype)
        vl[slot, off] = v.to(vl.dtype)
        out = kernel_ops.flash_decode_paged(
            q[:, 0].reshape(B, KVH, H // KVH, Dh).contiguous(), kl, vl,
            block_table, attn_len)
        out = out.reshape(B, H * Dh).to(h.dtype)
        h = h + out @ lp["wo"].reshape(H * Dh, cfg.d_model)
        m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + mlp_forward(lp, m_in, cfg.mlp_act, cfg.mlp_gated)

    x = rms_norm(h, model.final_norm, cfg.norm_eps)
    return unembed(model, x), k_slab, v_slab
