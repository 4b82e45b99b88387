"""Every decoder family of the reference as an ``nn.Module``: the
attention decoders (the Llama-3 family, MoE, plain MLPs, a ViT or
EnCodec front-end stub, gemma2's local/global layers with softcaps and
tied embeddings, MLA) and the two recurrent ones (``family_kind``):
RWKV6 (time mix and channel mix, ``models/rwkv6.py``) and zamba2
(Mamba2 blocks, ``models/mamba2.py``, with one shared attention + MLP
block applied before every group of ``shared_attn_every`` blocks, its
q and v projections plus a per-group LoRA delta).

Parameters are stacked along a leading layer dim, exactly like the
reference's pytree (``layers.attn.wq`` [L, d, H, Dh], ...), so
``from_jax_params`` carries a reference ``init_params`` tree across as
is.  ``forward`` runs a whole sequence (causal ``attn_forward`` per
layer, an optional ``image_embeds`` prefix through ``vit_proj``) and
``prefill`` returns its last-token logits and its K/V cache.
Three decode steps share one per-layer body (norm, attention, MLP or
MoE) and differ only in the attention (``models/attention.py``):
``serve_step_paged`` writes the new token's K/V into a block-table page
slab and attends with the ``flash_decode_paged`` kernel;
``serve_step_paged_spliced`` does the same over a table that also holds
spliced chunk-KV pages and attends with the ``flash_decode_spliced``
kernel; ``serve_step`` writes it into a dense ``init_cache`` cache and
attends with the ``flash_decode`` kernel: gemma2's split cache as local
rings of W slots (even layers) and full global caches (odd layers),
int8 K/V with per-(token, head) scales under ``kv_quant``
(``flash_decode_quant``), MLA's latent cache through ``mla_decode``.
Paged decode takes the global-causal GQA family only, as the
reference's ``supports_paged_decode``.  The MLP is gated or plain
(``mlp_gated``) or an MoE layer (``models/moe.py``); an EnCodec model
(musicgen) sums its codebooks' embeddings and emits logits
[..., codebooks, V].  Training runs through the same ``forward``
(``remat`` recomputes groups of layers in backward) and ``loss_fn``; a
model is trainable only after ``set_trainable()``, so serving stays
gradient-free.  The recurrent families carry a per-request state in a
dense cache instead of K/V that grows: RWKV6's token shifts and fp32
wkv state a layer (no attention, no decode kernel), zamba2's shared
block's K/V a group (decoded through ``flash_decode``, one grid a group
a step) beside each Mamba2 block's conv inputs and fp32 SSD state.
They serve dense only.  Every family trains through ``loss_fn``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.tensor_parallel import (TPGroup, TPRank, bind,
                                                     prefill_block)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models import rwkv6
from repro_torch.models.layers import (largest_divisor, mlp_forward,
                                      rms_norm, softcap, token_nll)

# flat parameter name -> its path in the reference pytree (the Llama
# family's names; checkpoints key parameters by these paths)
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
# the other families' parameters: the MoE router and dense residual, the
# ViT stub's projection, MLA's projections
_FAMILY_PATHS = {
    "router": ("layers", "mlp", "router"),
    "dense_w_up": ("layers", "mlp", "dense", "w_up"),
    "dense_w_gate": ("layers", "mlp", "dense", "w_gate"),
    "dense_w_down": ("layers", "mlp", "dense", "w_down"),
    "vit_proj": ("vit_proj",),
    **{name: ("layers", "attn", name) for name in mla.PARAMS},
    # RWKV6's layers [L, ...]; zamba2's Mamba2 blocks [G, per, ...], its
    # shared block (unstacked) and the block's LoRA deltas [G, ...]
    "tm_norm": ("layers", "tm_norm"), "cm_norm": ("layers", "cm_norm"),
    **{name: ("layers", "tm", name) for name in rwkv6.PARAMS},
    "norm": ("layers", "norm"),
    **{name: ("layers", "mamba", name) for name in mamba2.PARAMS},
    "shared_attn_norm": ("shared", "attn_norm"),
    **{"shared_" + n: ("shared", "attn", n) for n in ("wq", "wk", "wv", "wo")},
    "shared_mlp_norm": ("shared", "mlp_norm"),
    **{"shared_" + n: ("shared", "mlp", n) for n in ("w_up", "w_gate", "w_down")},
    **{"lora_" + n: ("lora", n) for n in ("qa", "qb", "va", "vb")},
}
_LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
                 "w_up", "w_gate", "w_down", "dense_w_up", "dense_w_gate",
                 "dense_w_down") + mla.PARAMS + (
                     "tm_norm", "cm_norm", "norm") + rwkv6.PARAMS + mamba2.PARAMS
# the parameters the reference's makers draw at a scale of their own (the
# others at 1/sqrt(fan_in), norms ones, conv_b zeros)
_INIT_SCALES = {**rwkv6.INIT_SCALES, **mamba2.INIT_SCALES, "lora_qb": 0.01,
                "lora_vb": 0.01}


def family_kind(cfg: ArchConfig) -> str:
    """The reference's decoder family: "rwkv6", "zamba2" or "attn"."""
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return "rwkv6"
    if cfg.shared_attn_every:
        return "zamba2"
    return "attn"


def codebooks(cfg: ArchConfig) -> int:
    """EnCodec codebooks of an audio model (tokens [..., n], logits
    [..., n, V]), else 0."""
    fe = cfg.frontend
    return fe.num_codebooks if fe is not None and fe.kind == "encodec_stub" else 0


def zamba2_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """zamba2's (groups G, Mamba2 blocks a group): one shared-block
    application before each group."""
    per = cfg.shared_attn_every
    if cfg.num_layers % per:
        raise ValueError(f"zamba2: {cfg.num_layers} layers do not divide "
                         f"into groups of {per}")
    return cfg.num_layers // per, per


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a decoder this module implements: an
    attention decoder (GQA with any rotary fraction, a sliding window or
    gemma2's local/global pattern in pairs, logit softcaps; or MLA; a
    gated or plain MLP or MoE, separate or tied embeddings, a ViT or
    EnCodec front-end stub), RWKV6 (attention-free, whole heads) or
    zamba2 (Mamba2 blocks in whole groups around a GQA shared block)."""
    kind = family_kind(cfg)
    if kind == "rwkv6":
        ok = (cfg.attn_kind == "none"
              and cfg.d_model % cfg.ssm.head_dim == 0)
    elif kind == "zamba2":
        ok = (cfg.ssm is not None and cfg.ssm.kind == "mamba2"
              and cfg.attn_kind == "gqa"
              and cfg.num_layers % cfg.shared_attn_every == 0)
    else:
        ok = (cfg.ssm is None
              and (cfg.attn_kind == "gqa"
                   or (cfg.attn_kind == "mla" and cfg.mla is not None))
              and not (cfg.local_global_pattern and cfg.sliding_window
                       and cfg.num_layers % 2))
    if not ok:
        raise ValueError(f"arch {cfg.name!r} is not a ported decoder (GQA "
                         "or MLA attention, local/global layers in pairs; "
                         "attention-free RWKV6; zamba2's Mamba2 blocks in "
                         "whole groups around a GQA shared block)")


def _shared_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """zamba2's shared attention + MLP block and its per-group LoRA
    deltas [G, ...] (the reference's ``shared`` and ``lora`` trees)."""
    d, F, r = cfg.d_model, cfg.d_ff, cfg.shared_attn_lora_rank
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, _ = zamba2_groups(cfg)
    shapes = {"shared_attn_norm": (d,), "shared_wq": (d, H, Dh),
              "shared_wk": (d, KVH, Dh), "shared_wv": (d, KVH, Dh),
              "shared_wo": (H, Dh, d), "shared_mlp_norm": (d,),
              "shared_w_up": (d, F)}
    if cfg.mlp_gated:
        shapes["shared_w_gate"] = (d, F)
    shapes["shared_w_down"] = (F, d)
    shapes.update({"lora_qa": (G, d, r), "lora_qb": (G, r, H * Dh),
                   "lora_va": (G, d, r), "lora_vb": (G, r, KVH * Dh)})
    return shapes


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of every parameter: layer params stacked along dim 0
    (zamba2's Mamba2 blocks along [G, per], its LoRA deltas along G)."""
    d, L, V, F = cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.d_ff
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    nc = codebooks(cfg)
    shapes = {"embed": (nc, V, d) if nc else (V, d)}
    if nc or not cfg.tie_embeddings:
        shapes["unembed"] = (nc, d, V) if nc else (d, V)
    shapes["final_norm"] = (d,)
    kind = family_kind(cfg)
    if kind == "rwkv6":
        shapes["tm_norm"] = (L, d)
        shapes.update({n: (L,) + sh
                       for n, sh in rwkv6.rwkv6_param_shapes(cfg).items()})
        shapes["cm_norm"] = (L, d)
        return shapes
    if kind == "zamba2":
        G, per = zamba2_groups(cfg)
        shapes["norm"] = (G, per, d)
        shapes.update({n: (G, per) + sh
                       for n, sh in mamba2.mamba2_param_shapes(cfg).items()})
        shapes.update(_shared_shapes(cfg))
        return shapes
    shapes["attn_norm"] = (L, d)
    if cfg.attn_kind == "mla":
        shapes.update({n: (L,) + sh for n, sh in mla.mla_param_shapes(cfg).items()})
    else:
        shapes.update({"wq": (L, d, H, Dh), "wk": (L, d, KVH, Dh),
                       "wv": (L, d, KVH, Dh), "wo": (L, H, Dh, d)})
    shapes["mlp_norm"] = (L, d)
    if cfg.moe is not None:
        E, Fe, Fd = (cfg.moe.num_experts, cfg.moe.d_ff_expert,
                     cfg.moe.dense_residual_d_ff)
        shapes.update({"router": (L, d, E), "w_up": (L, E, d, Fe),
                       "w_gate": (L, E, d, Fe), "w_down": (L, E, Fe, d)})
        if Fd:
            shapes.update({"dense_w_up": (L, d, Fd), "dense_w_gate": (L, d, Fd),
                           "dense_w_down": (L, Fd, d)})
    else:
        shapes["w_up"] = (L, d, F)
        if cfg.mlp_gated:
            shapes["w_gate"] = (L, d, F)
        shapes["w_down"] = (L, F, d)
    if cfg.frontend is not None and cfg.frontend.kind == "vit_stub":
        shapes["vit_proj"] = (cfg.frontend.embed_dim, d)
    return shapes


# each parameter's logical axes, one layer's (the reference's makers'
# ``axes``; ``param_axes`` puts "layers" in front of a stacked one); the
# MoE experts' and an audio model's embeddings are set by ``param_axes``
_ATTN_AXES = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
              "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
_MLP_AXES = {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}
_AXES = {
    "embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
    "final_norm": ("embed",), "vit_proj": (None, "embed"),
    **{n: ("embed",) for n in ("attn_norm", "mlp_norm", "tm_norm", "cm_norm",
                               "norm", "shared_attn_norm", "shared_mlp_norm")},
    **_ATTN_AXES, **_MLP_AXES, "router": ("embed", None),
    **{"dense_" + n: ax for n, ax in _MLP_AXES.items()},
    **mla.AXES, **rwkv6.AXES, **mamba2.AXES,
    **{"shared_" + n: ax for n, ax in {**_ATTN_AXES, **_MLP_AXES}.items()},
    "lora_qa": ("embed", None), "lora_qb": (None, "heads_flat"),
    "lora_va": ("embed", None), "lora_vb": (None, "heads_flat"),
}


def param_axes(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's logical axes, by name (``param_shapes``'s keys):
    the reference's ``param_axes`` at the leaf each name maps to, a
    stacked parameter's layer dims named "layers" (zamba2's Mamba2
    blocks ("layers", "layers", ...))."""
    experts = cfg.moe is not None
    audio = codebooks(cfg) > 0
    out = {}
    for name, shape in param_shapes(cfg).items():
        ax = _AXES[name]
        if experts and name in _MLP_AXES:
            ax = ("experts",) + ax
        if audio and name in ("embed", "unembed"):
            ax = (None,) + ax
        ax = ("layers",) * _stacked(cfg, name) + ax
        if len(ax) != len(shape):
            raise ValueError(f"{name}: axes {ax} for shape {shape}")
        out[name] = ax
    return out


def _stacked(cfg: ArchConfig, name: str) -> int:
    """How many leading dims of parameter ``name`` stack layers: 2 for
    zamba2's Mamba2 blocks [G, per], 1 for other layer params and the
    LoRA deltas, 0 for the rest."""
    if name.startswith("lora_"):
        return 1
    if name not in _LAYER_PARAMS:
        return 0
    return 2 if family_kind(cfg) == "zamba2" else 1


class Transformer(nn.Module):
    """Decoder weights plus the paged decode step.  The parameters take
    no gradients until ``set_trainable()``."""

    layer_names: Tuple[str, ...]     # this config's per-layer parameters

    def __init__(self, cfg: ArchConfig, tensors: Mapping[str, torch.Tensor],
                 layout=None):
        """``layout``: a ``tensor_parallel.TPLayout`` when ``tensors`` are
        one rank's blocks (``tensor_parallel.shard_model``), whose steps
        then take that rank's ``tp`` group."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp_layout = layout
        shapes = param_shapes(cfg) if layout is None else layout.local_shapes()
        if set(tensors) != set(shapes):
            raise ValueError(f"want parameters {sorted(shapes)}, got "
                             f"{sorted(tensors)}")
        for name, t in tensors.items():
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                                 f"{shapes[name]}")
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.layer_names = tuple(n for n in shapes if n in _LAYER_PARAMS)
        self._per = zamba2_groups(cfg)[1] if family_kind(cfg) == "zamba2" else 0

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def set_trainable(self, on: bool = True) -> "Transformer":
        """Let every parameter take gradients (or stop them); returns
        the model."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self

    def _stack(self, name: str) -> torch.Tensor:
        """Parameter ``name`` with its layers along dim 0 (zamba2's
        [G, per] flattened, group-major)."""
        t = getattr(self, name)
        return t.flatten(0, 1) if self._per else t

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l``'s parameters (views into the stacked tensors;
        zamba2's Mamba2 block l is block l % per of group l // per)."""
        return {name: self._stack(name)[l] for name in self.layer_names}

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's parameters, for a full-sequence pass: each
        stacked parameter taken apart once by ``unbind``, whose backward
        is one ``stack`` into a gradient allocated once.  Backward of a
        ``layer(l)`` index a layer would instead allocate a zero tensor
        the size of the whole stack for every layer (3.8 GB for
        Llama-3-8B's stacked MLP weights)."""
        stacks = [self._stack(name).unbind(0) for name in self.layer_names]
        return [dict(zip(self.layer_names, parts)) for parts in zip(*stacks)]

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
    ``InitMaker``: E for the [E, d, F] expert weights), embedding scale
    0.02, norms ones, RWKV6's and Mamba2's explicitly scaled parameters
    and zamba2's LoRA B matrices at the reference's scales, the Mamba2
    conv bias zeros.  Layer tensors are filled one layer at a time, and
    expert tensors one expert at a time, so the fp32 scratch stays one
    layer's matrix big (arctic's [128, 7168, 4864] w_up of a layer would
    take 17.8 GB)."""
    dev = resolve_device(device)
    tensors: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=dev)
        if name.endswith("norm") or name == "gn_scale":
            t.fill_(1.0)
        elif name == "conv_b":
            t.zero_()
        else:
            k = _stacked(cfg, name)
            per = shape[k:]
            scale = (0.02 if name == "embed" else _INIT_SCALES.get(
                name, 1.0 / math.sqrt(max(per[0], 1))))
            experts = cfg.moe is not None and name in ("w_up", "w_gate", "w_down")
            parts = [t] if not k else t.flatten(0, k - 1 + experts)
            for part in parts:
                tmp = torch.empty(part.shape, dtype=torch.float32, device=dev)
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
    paths = {**_JAX_PATHS, **_FAMILY_PATHS}
    tensors = {}
    for name in param_shapes(cfg):
        node = np_tree
        for key in paths[name]:
            node = node[key]
        t = torch.from_numpy(np.array(node))       # own, writable copy
        tensors[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return Transformer(cfg, tensors)


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Each layer's attention window (0 = global): gemma2 alternates a
    local layer (even) with a global one (odd)."""
    W, L = cfg.sliding_window or 0, cfg.num_layers
    if cfg.local_global_pattern and W:
        return [W if i % 2 == 0 else 0 for i in range(L)]
    return [W] * L


def embed_tokens(model: Transformer, tokens: torch.Tensor,
                 tp: Optional[TPRank] = None) -> torch.Tensor:
    """tokens [...] (an audio model's [..., codebooks]) -> embeddings
    [..., d]; the codebooks' embeddings summed in order, as the
    reference sums them; tied embeddings (gemma) scaled by sqrt(d) in
    the embedding's dtype.  On a rank whose block holds part of the
    vocabulary, each row comes from the rank that holds it (one masked
    lookup and all-reduce, of every codebook at once, before the sum);
    under FSDP each row's column blocks come from the data shards that
    hold them (``TPRank.embed_lookup``), the table never gathered."""
    cfg = model.cfg
    tokens = tokens.long()
    nc = codebooks(cfg)
    vocab = tp.layout.vocab if tp is not None else None
    if vocab is not None or (tp is not None
                             and tp.layout.data_dim("embed") is not None):
        rows = tp.embed_lookup(model.embed, tokens,
                               None if vocab is None else vocab[0])
        x = rows if not nc else rows[..., 0, :]
        for c in range(1, nc):
            x = x + rows[..., c, :]
    elif not nc:
        x = model.embed[tokens]
    else:
        x = model.embed[0][tokens[..., 0]]
        for c in range(1, nc):
            x = x + model.embed[c][tokens[..., c]]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _param(model: Transformer, name: str, tp: Optional[TPRank] = None
           ) -> torch.Tensor:
    """Parameter ``name`` (not a layer's) as the layers use it: on a
    rank, its ``model`` block (gathered over ``data`` under FSDP)."""
    t = getattr(model, name)
    return t if tp is None else tp.whole(name, t)


def out_table(model: Transformer, tp: Optional[TPRank] = None
              ) -> torch.Tensor:
    """The table ``unembed`` multiplies by (the embedding when tied), as
    ``_param`` gives it."""
    return _param(model, "embed" if model.cfg.tie_embeddings
                  and not codebooks(model.cfg) else "unembed", tp)


def unembed(model: Transformer, x: torch.Tensor,
            tp: Optional[TPRank] = None, gather: bool = True,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., d] -> logits [..., V] (an audio model's [..., codebooks,
    V]); through the embedding when tied (``table``: ``out_table``, where
    the caller gathered it once); capped at the config's final logit
    softcap.  On a rank whose block holds part of the vocabulary, its
    logits' columns are all-gathered from every rank (``gather``; else
    the rank's columns alone, x entering them through "f")."""
    split = tp is not None and tp.layout.unembed_vocab is not None
    if split and not gather:
        x = tp.copy(x)
    if table is None:
        table = out_table(model, tp)
    if codebooks(model.cfg):
        logits = torch.einsum("...d,cdv->...cv", x, table)
    elif model.cfg.tie_embeddings:
        logits = x @ table.T
    else:
        logits = x @ table
    if split and gather:
        logits = tp.gather_last(logits)
    return softcap(logits, model.cfg.final_logit_softcap)


def _mlp(lp: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
         tp: Optional[TPRank] = None, want_aux: bool = True,
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP or MoE on x [..., d]: (out, MoE aux loss or None);
    on a rank, the MLP column-parallel (x through "f") then row-parallel,
    all-reduced where its hidden dim splits, and the MoE aux loss (whose
    sums cross ``data``) only where ``want_aux``."""
    if cfg.moe is not None:   # the unsharded call keeps its three arguments
        return (moe.moe_forward(lp, x, cfg) if tp is None
                else moe.moe_forward(lp, x, cfg, tp, want_aux))
    if tp is not None:
        x = tp.copy(x, tp.layout.mlp_split)
    out = mlp_forward(lp, x, cfg.mlp_act, cfg.mlp_gated)
    if tp is not None:
        out = tp.reduce(out, tp.layout.mlp_split)
    return out, None


def _block(x: torch.Tensor, aux: torch.Tensor, lp: Dict[str, torch.Tensor],
           cfg: ArchConfig, positions: torch.Tensor, attn_chunk: int,
           window: int = 0, tp: Optional[TPRank] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor,
                      Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer over a whole sequence: (x out, aux plus the
    layer's MoE aux loss, the layer's cache pair: (k, v), or MLA's
    (c_kv, k_pe))."""
    a_in = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a_out, kv = mla.mla_forward(lp, a_in, cfg, positions=positions,
                                    attn_chunk=attn_chunk)
    else:
        a_out, kv = attn.attn_forward(lp, a_in, cfg, positions=positions,
                                      window=window, attn_chunk=attn_chunk,
                                      tp=tp)
    x = x + a_out
    m_out, a = _mlp(lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps), cfg, tp)
    return x + m_out, aux if a is None else aux + a, kv


def forward(model: Transformer, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            attn_chunk: int = 1024, remat: bool = False,
            remat_group: int = 4, want_cache: bool = False,
            tp: Optional[TPGroup] = None, act_spec: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor,
                       Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence forward: tokens [B, S] (an audio model's [B, S,
    codebooks]), after a vision model's ``image_embeds`` [B, P, e]
    projected through ``vit_proj`` as a prefix, at positions 0..P+S-1.
    Returns (hidden [B, P+S, d] after the final norm, the MoE aux loss
    summed over layers (0 without MoE), cache or None); ``want_cache``
    gives {"k", "v"} [L, B, P+S, KVH, Dh], k rotated (MLA: {"ckv",
    "kpe"} [L, B, P+S, R] and [L, B, P+S, Dr]), in the model's dtype, as
    the reference's ``forward`` lays out its attention cache.  Each
    layer attends within its ``layer_windows`` window.

    ``remat=True`` (without ``want_cache``, as the reference's grouped
    path) runs the layers in groups of ``remat_group`` (the largest
    divisor of L not above it) under ``torch.utils.checkpoint``: backward
    recomputes each group from its input, so only L/g residuals are
    kept.  The values are the same either way.

    The recurrent families start every layer from a zero shift and
    state, as the reference's ``forward``; under ``remat`` RWKV6 runs its
    layers in groups of ``remat_group`` (the largest divisor of L not
    above it) and zamba2 each group (the shared block with its LoRA
    merge, then its Mamba2 blocks) under one checkpoint, as the
    reference does.  Their cache is RWKV6's {"shift1", "wkv", "shift2"}
    [L, B, ...] or zamba2's {"shared_k", "shared_v"} [G, B, S, KVH, Dh]
    and {"conv", "ssd"} [G, per, B, ...] (``cache_shapes``'s layout, the
    states as the blocks return them).

    ``tp``: a rank's model (``tensor_parallel.shard_model``) runs with
    its ``model`` group: its layers on their blocks, its cache the
    rank's KV heads (all of them where they do not split); with
    gradients on, as a train step's (Megatron's "f" and "g" around the
    collectives, ``check_tp_supported(entry="train_step")``).
    ``act_spec`` (with ``tp`` and ``remat``): the reference's
    ``act_spec`` over ``model``, the residual stream saved at each remat
    group's boundary the rank's ``d / model`` columns
    (``TPRank.split_last``), all-gathered when the group runs and when
    backward recomputes it; the values are the same either way.  Under
    FSDP each layer's parameters are gathered over ``data`` where the
    layer runs (``TPRank.layer``: inside a remat group, so backward's
    recompute gathers them again), never a whole stacked tensor."""
    cfg = model.cfg
    tp = bind(model, tp, "train_step" if torch.is_grad_enabled()
              else "prefill")
    x = embed_tokens(model, tokens, tp)                  # [B, S, d]
    if image_embeds is not None:
        prefix = torch.einsum("bpe,ed->bpd", image_embeds.to(x.dtype),
                              _param(model, "vit_proj", tp))
        x = torch.cat([prefix, x], dim=1)
    kind = family_kind(cfg)
    if kind != "attn":
        remat = remat and not want_cache
        x, cache = (_rwkv6_forward(model, x, want_cache, remat, remat_group)
                    if kind == "rwkv6" else
                    _zamba2_forward(model, x, attn_chunk, want_cache, remat))
        return (rms_norm(x, model.final_norm, cfg.norm_eps),
                torch.zeros((), dtype=torch.float32, device=x.device), cache)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    layers = model.layers()
    windows = layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    if remat and not want_cache:
        g = largest_divisor(cfg.num_layers, remat_group)
        sliced = act_spec and tp is not None and tp.layout.size > 1
        if sliced and cfg.d_model % tp.layout.size:
            raise ValueError(f"act_spec: d_model {cfg.d_model} does not "
                             f"split over {tp.layout.size} ranks")

        def group(h, a, lps, wins):
            if sliced:
                h = tp.gather_last(h)
            for lp, w in zip(lps, wins):
                if tp is not None:
                    lp = tp.layer(lp)
                h, a, _ = _block(h, a, lp, cfg, positions, attn_chunk, w, tp)
            return (tp.split_last(h) if sliced else h), a

        if sliced:
            x = tp.split_last(x)
        for i in range(0, cfg.num_layers, g):
            x, aux = checkpoint(group, x, aux, layers[i:i + g],
                                windows[i:i + g], use_reentrant=False)
        if sliced:
            x = tp.gather_last(x)
    else:
        for lp, w in zip(layers, windows):
            if tp is not None:
                lp = tp.layer(lp)
            x, aux, (k, v) = _block(x, aux, lp, cfg, positions, attn_chunk, w,
                                    tp)
            if want_cache:
                ks.append(k)
                vs.append(v)
    names = ("ckv", "kpe") if cfg.attn_kind == "mla" else ("k", "v")
    cache = ({names[0]: torch.stack(ks), names[1]: torch.stack(vs)}
             if want_cache else None)
    return (rms_norm(x, _param(model, "final_norm", tp), cfg.norm_eps), aux,
            cache)


def _rwkv6_layer(cfg: ArchConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One RWKV6 layer over x [B, S, d] (time mix, then channel mix, each
    after its norm and from a zero shift and state): (x, (shift1, wkv,
    shift2) after it)."""
    B, d = x.shape[0], cfg.d_model
    K = cfg.ssm.head_dim
    zero = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    st = torch.zeros((B, d // K, K, K), dtype=torch.float32, device=x.device)
    y, s1, wkv = rwkv6.rwkv6_time_mix(
        lp, rms_norm(x, lp["tm_norm"], cfg.norm_eps), cfg, shift_in=zero,
        state_in=st)
    x = x + y
    y, s2 = rwkv6.rwkv6_channel_mix(
        lp, rms_norm(x, lp["cm_norm"], cfg.norm_eps), zero)
    return x + y, (s1, wkv, s2)


def _rwkv6_group(cfg: ArchConfig, x: torch.Tensor,
                 lps: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """``lps``' RWKV6 layers in turn over x."""
    for lp in lps:
        x, _ = _rwkv6_layer(cfg, x, lp)
    return x


def _rwkv6_forward(model: Transformer, x: torch.Tensor, want_cache: bool,
                   remat: bool, remat_group: int,
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """RWKV6's layers over x [B, S, d]: (x, cache or None); ``remat``
    runs them in groups of ``largest_divisor(L, remat_group)``, each
    under ``torch.utils.checkpoint``."""
    cfg = model.cfg
    layers = model.layers()
    if remat:
        g = largest_divisor(cfg.num_layers, remat_group)
        for i in range(0, cfg.num_layers, g):
            x = checkpoint(_rwkv6_group, cfg, x, layers[i:i + g],
                           use_reentrant=False)
        return x, None
    states = []
    for lp in layers:
        x, st = _rwkv6_layer(cfg, x, lp)
        if want_cache:
            states.append(st)
    if not want_cache:
        return x, None
    s1, wkv, s2 = (torch.stack(t) for t in zip(*states))
    return x, {"shift1": s1, "wkv": wkv, "shift2": s2}


def shared_block(model: Transformer, g: int,
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """zamba2's shared block as group ``g`` applies it: (attention
    weights {"wq", "wk", "wv", "wo"}, MLP weights).  ``wq`` and ``wv``
    get the group's LoRA delta ``qa @ qb`` / ``va @ vb`` in the weights'
    dtype, reshaped to [d, H, Dh] / [d, KVH, Dh], each call: the
    reference merges them where it applies the block, and so does every
    caller here, so the merged weights are the reference's own sums."""
    cfg = model.cfg
    d, H, KVH, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    ap = {"wq": model.shared_wq + (model.lora_qa[g] @ model.lora_qb[g]
                                   ).reshape(d, H, Dh),
          "wk": model.shared_wk,
          "wv": model.shared_wv + (model.lora_va[g] @ model.lora_vb[g]
                                   ).reshape(d, KVH, Dh),
          "wo": model.shared_wo}
    mp = {"w_up": model.shared_w_up, "w_down": model.shared_w_down}
    if cfg.mlp_gated:
        mp["w_gate"] = model.shared_w_gate
    return ap, mp


def _shared_mlp(model: Transformer, mp: Dict[str, torch.Tensor],
                h: torch.Tensor) -> torch.Tensor:
    """h plus the shared block's MLP of its norm."""
    cfg = model.cfg
    return h + mlp_forward(mp, rms_norm(h, model.shared_mlp_norm, cfg.norm_eps),
                           cfg.mlp_act, cfg.mlp_gated)


def _zamba2_group(model: Transformer, x: torch.Tensor, g: int,
                 lps: List[Dict[str, torch.Tensor]], attn_chunk: int,
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                            List[Tuple[torch.Tensor, torch.Tensor]]]:
    """zamba2's group ``g`` over x [B, S, d]: the shared block (its LoRA
    deltas merged; global causal attention at positions 0..S-1, then
    its MLP) and the group's Mamba2 blocks ``lps``, each after its norm
    and from a zero conv input and state: (x, the shared block's (k, v),
    each block's (conv, ssd) state)."""
    cfg = model.cfg
    B, S = x.shape[:2]
    d_in, Hm, P, N = mamba2.mamba2_dims(cfg)
    cw = cfg.ssm.conv_width
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ap, mp = shared_block(model, g)
    a_out, kv = attn.attn_forward(
        ap, rms_norm(x, model.shared_attn_norm, cfg.norm_eps), cfg,
        positions=positions, window=0, attn_chunk=attn_chunk)
    x = _shared_mlp(model, mp, x + a_out)
    states = []
    for lp in lps:
        ci = torch.zeros((B, cw - 1, d_in + 2 * N), dtype=x.dtype,
                         device=x.device)
        si = torch.zeros((B, Hm, P, N), dtype=torch.float32, device=x.device)
        y, co, so = mamba2.mamba2_forward(
            lp, rms_norm(x, lp["norm"], cfg.norm_eps), cfg, conv_in=ci,
            state_in=si)
        x = x + y
        states.append((co, so))
    return x, kv, states


def _zamba2_forward(model: Transformer, x: torch.Tensor, attn_chunk: int,
                    want_cache: bool, remat: bool,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """zamba2 over x [B, S, d], group by group (``_zamba2_group``): (x,
    cache or None); ``remat`` runs each group under
    ``torch.utils.checkpoint``, so backward merges its LoRA deltas
    again."""
    G, per = zamba2_groups(model.cfg)
    layers = model.layers()
    kvs, states = [], []
    for g in range(G):
        lps = layers[g * per:(g + 1) * per]
        if remat:           # the group's x alone: its states are dropped
            x = checkpoint(_zamba2_group, model, x, g, lps, attn_chunk,
                           use_reentrant=False)[0]
            continue
        x, kv, st = _zamba2_group(model, x, g, lps, attn_chunk)
        kvs.append(kv)
        states.extend(st)
    if not want_cache:
        return x, None
    k, v = (torch.stack(t) for t in zip(*kvs))
    conv, ssd = (torch.stack(t).unflatten(0, (G, per)) for t in zip(*states))
    return x, {"shared_k": k, "shared_v": v, "conv": conv, "ssd": ssd}


def loss_fn(model: Transformer, batch: Mapping[str, torch.Tensor], *,
            attn_chunk: int = 1024, remat: bool = True, remat_group: int = 4,
            loss_chunk: int = 512, tp: Optional[TPGroup] = None,
            act_spec: bool = False,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean LM loss of ``batch`` {"tokens", "labels"} [B, S] (an
    audio model's [B, S, codebooks]), an optional "loss_mask" [B, S] and
    a vision model's "image_embeds" [B, P, e]: ``forward`` (the image
    prefix first), the prefix's P positions cut, then the unembedding
    and the fp32 NLL (an audio model's mean over its codebooks) over
    sequence chunks of S/n positions (n the largest divisor of S not
    above S // loss_chunk, at least 1), each chunk under
    ``torch.utils.checkpoint``, so backward recomputes its [B, c, V]
    logits and the whole sequence's are never kept, as the reference's
    ``loss_fn`` does.  Returns (loss = ce + the MoE aux loss, {"ce",
    "aux", "tokens"}), all fp32 scalars.

    ``tp``: a rank's model with its group (``forward``, ``act_spec``
    too).  Where the rank holds part of the unembedding's vocabulary,
    the loss is vocabulary-parallel over the rank's logit columns within
    each chunk (``TPRank.nll``), the [B, c, V] logits never gathered.
    With a ``data`` axis the batch is this shard's rows of the global
    one: the token count is summed over ``data`` and the NLL sum through
    "g" (all-reduce forward, identity backward), so every shard returns
    the global batch's loss and backward reaches its own tokens.  Under
    FSDP the unembedding is gathered once for every chunk
    (``out_table``), its gradient reduce-scattered once."""
    labels, mask = batch["labels"], batch.get("loss_mask")
    image_embeds = batch.get("image_embeds")
    x, aux, _ = forward(model, batch["tokens"], image_embeds=image_embeds,
                        attn_chunk=attn_chunk, remat=remat,
                        remat_group=remat_group, tp=tp, act_spec=act_spec)
    rank = bind(model, tp, "train_step" if torch.is_grad_enabled()
                else "prefill")
    vocab_split = rank is not None and rank.layout.unembed_vocab is not None
    if image_embeds is not None:
        x = x[:, image_embeds.shape[1]:]        # the loss on text positions
    S = x.shape[1]
    c = S // largest_divisor(S, max(S // loss_chunk, 1))
    table = out_table(model, rank)

    def chunk_loss(xc, lc, mc, w):
        if vocab_split:
            nll = rank.nll(unembed(model, xc, rank, gather=False, table=w), lc)
        else:
            nll = token_nll(unembed(model, xc, rank, table=w), lc)
        if nll.dim() == 3:                      # audio: [B, c, codebooks]
            nll = nll.mean(-1)
        return torch.sum(nll * mc), torch.sum(mc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        lc = labels[:, i:i + c]
        mc = (torch.ones(lc.shape[:2], dtype=torch.float32, device=x.device)
              if mask is None else mask[:, i:i + c].float())
        t, n = checkpoint(chunk_loss, x[:, i:i + c], lc, mc, table,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    if rank is not None and rank.data_size > 1:
        cnt = rank.group.all_reduce_sum(cnt.detach(), "data")
        tot = rank.reduce(tot, True, "data")
    ce = tot / torch.clamp(cnt, min=1.0)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}


def prefill(model: Transformer, inputs: Dict[str, torch.Tensor], *,
            attn_chunk: int = 1024, tp: Optional[TPGroup] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-prompt forward of ``inputs["tokens"]`` [B, S] (after an
    ``inputs["image_embeds"]`` [B, P, e] prefix, where given): returns
    (last-token logits [B, V] (audio [B, codebooks, V]), cache {"k", "v"}
    [L, B, P+S, KVH, Dh] at the prompt's length).  MLA's cache is
    {"ckv", "kpe"}; gemma2's is split as the reference hands it to
    decode: the local (even) layers' K/V as rings of W slots
    (``ring_from_full``), "k_local"/"v_local" [L/2, B, W, KVH, Dh], the
    global (odd) layers' whole, "k_global"/"v_global"; RWKV6's and
    zamba2's are their states after the prompt (``forward``).

    ``tp``: a rank's model with its ``model`` group (``forward``): the
    logits gathered whole, the cache the rank's block of it (its KV
    heads; along the sequence where the rules split ``kv_seq`` over
    ``model``)."""
    cfg = model.cfg
    x, _, cache = forward(model, inputs["tokens"],
                          image_embeds=inputs.get("image_embeds"),
                          attn_chunk=attn_chunk, want_cache=True, tp=tp)
    if tp is not None:
        rank = bind(model, tp, "prefill")
        cache = prefill_block(rank.layout, cache)
        return unembed(model, x[:, -1, :], rank), cache
    if cfg.local_global_pattern and cfg.sliding_window:
        W = cfg.sliding_window
        cache = {"k_local": attn.ring_from_full(cache["k"][0::2], W),
                 "v_local": attn.ring_from_full(cache["v"][0::2], W),
                 "k_global": cache["k"][1::2], "v_global": cache["v"][1::2]}
    return unembed(model, x[:, -1, :]), cache


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, kv_quant: bool = False,
                 kv_heads: Optional[int] = None,
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each tensor of ``init_cache``, key for key as
    the reference's: MLA {"ckv" [L, B, S, R], "kpe" [L, B, S, Dr]};
    gemma2's split cache {"k_local", "v_local" [L/2, B, W, KVH, Dh] with
    W = min(window, max_len), "k_global", "v_global" [L/2, B, S, KVH,
    Dh]}; RWKV6 {"shift1", "shift2" [L, B, d] and "wkv" [L, B, H, K, K]
    fp32}; zamba2 {"shared_k", "shared_v" [G, B, S, KVH, Dh], "conv"
    [G, per, B, cw - 1, d_in + 2N] and "ssd" [G, per, B, Hm, P, N]
    fp32}; else {"k", "v"} [L, B, S, KVH, Dh].  ``kv_quant`` stores the
    full-length K/V int8 with bf16 scales [..., S, KVH] beside them
    ("k_scale"/"v_scale", or "k_global_scale"/"v_global_scale"; the
    local rings stay in ``dtype``); the recurrent families ignore it, as
    the reference's do.  ``kv_heads``: the KV heads a rank's cache holds
    (``tensor_parallel.local_kv_heads``), default all of them."""
    check_supported(cfg)
    L, B, S = cfg.num_layers, batch, max_len
    kind = family_kind(cfg)
    if kind == "rwkv6":
        K = cfg.ssm.head_dim
        return {"shift1": ((L, B, cfg.d_model), dtype),
                "wkv": ((L, B, cfg.d_model // K, K, K), torch.float32),
                "shift2": ((L, B, cfg.d_model), dtype)}
    if kind == "zamba2":
        G, per = zamba2_groups(cfg)
        d_in, Hm, P, N = mamba2.mamba2_dims(cfg)
        kv = (G, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"shared_k": (kv, dtype), "shared_v": (kv, dtype),
                "conv": ((G, per, B, cfg.ssm.conv_width - 1, d_in + 2 * N),
                         dtype),
                "ssd": ((G, per, B, Hm, P, N), torch.float32)}
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {"ckv": ((L, B, S, m.kv_lora_rank), dtype),
                "kpe": ((L, B, S, m.qk_rope_head_dim), dtype)}
    KVH, Dh = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim
    kv_dt = torch.int8 if kv_quant else dtype
    if cfg.local_global_pattern and cfg.sliding_window:
        W, Lp = min(cfg.sliding_window, max_len), L // 2
        out = {"k_local": ((Lp, B, W, KVH, Dh), dtype),
               "v_local": ((Lp, B, W, KVH, Dh), dtype),
               "k_global": ((Lp, B, S, KVH, Dh), kv_dt),
               "v_global": ((Lp, B, S, KVH, Dh), kv_dt)}
        scales = ("k_global_scale", "v_global_scale")
        Ls = Lp
    else:
        out = {"k": ((L, B, S, KVH, Dh), kv_dt), "v": ((L, B, S, KVH, Dh), kv_dt)}
        scales = ("k_scale", "v_scale")
        Ls = L
    if kv_quant:
        out.update({name: ((Ls, B, S, KVH), torch.bfloat16) for name in scales})
    return out


def cache_axes(cfg: ArchConfig, kv_quant: bool = False,
               ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each cache tensor's logical axes, by ``cache_shapes``'s keys (the
    reference's ``cache_axes``): K/V (layers, batch, kv_seq, kv_heads,
    None), their int8 scales without the last; MLA's latents (layers,
    batch, kv_seq, None); RWKV6's shifts and wkv state; zamba2's shared
    K/V a group and its blocks' conv and SSD states."""
    kind = family_kind(cfg)
    if kind == "rwkv6":
        return {"shift1": ("layers", "batch", "embed"),
                "wkv": ("layers", "batch", "heads_flat", None, None),
                "shift2": ("layers", "batch", "embed")}
    if kind == "zamba2":
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"shared_k": kv, "shared_v": kv,
                "conv": ("layers", "layers", "batch", None, "heads_flat"),
                "ssd": ("layers", "layers", "batch", "heads_flat", None, None)}
    if cfg.attn_kind == "mla":
        return {"ckv": ("layers", "batch", "kv_seq", None),
                "kpe": ("layers", "batch", "kv_seq", None)}
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    sc = ("layers", "batch", "kv_seq", "kv_heads")
    if cfg.local_global_pattern and cfg.sliding_window:
        out = {"k_local": kv, "v_local": kv, "k_global": kv, "v_global": kv}
        scales = ("k_global_scale", "v_global_scale")
    else:
        out = {"k": kv, "v": kv}
        scales = ("k_scale", "v_scale")
    if kv_quant:
        out.update({name: sc for name in scales})
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda",
               kv_quant: bool = False,
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A zeroed dense decode cache for ``batch`` sequences of ``max_len``
    tokens, laid out as the reference's ``init_cache`` (``cache_shapes``):
    GQA {"k", "v"}, gemma2's local rings and global caches, MLA's
    latent cache; ``kv_quant`` keeps the full-length K/V int8 with bf16
    scales, as ``serve_step(kv_quant=True)`` reads them; ``kv_heads`` a
    rank's KV heads (``cache_shapes``)."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_shapes(cfg, batch, max_len, dtype,
                                                  kv_quant, kv_heads).items()}


def _decode(model: Transformer, tokens: torch.Tensor,
            attend: Callable[[int, Dict[str, torch.Tensor], torch.Tensor],
                             torch.Tensor],
            tp: Optional[TPRank] = None) -> torch.Tensor:
    """The per-layer body the decode steps share: embed ``tokens`` [B]
    (audio [B, codebooks]), then per layer ``h += attend(l, layer,
    rms_norm(h))`` and the MLP or MoE (its B rows one dispatch group, in
    row order, as the reference's step dispatches them), then the final
    norm and the unembedding.  Returns logits [B, V] (audio [B,
    codebooks, V]).  On a rank (``tp``) each of those on its blocks,
    with their collectives (under FSDP each layer's parameters gathered
    over ``data`` before it runs, ``TPRank.layer``)."""
    cfg = model.cfg
    h = embed_tokens(model, tokens, tp)                  # [B, d]
    for l in range(cfg.num_layers):
        lp = model.layer(l)
        if tp is not None:
            lp = tp.layer(lp)
        h = h + attend(l, lp, rms_norm(h, lp["attn_norm"], cfg.norm_eps))
        m_out, _ = _mlp(lp, rms_norm(h, lp["mlp_norm"], cfg.norm_eps), cfg,
                        tp, want_aux=False)
        h = h + m_out
    return unembed(model, rms_norm(h, _param(model, "final_norm", tp),
                                   cfg.norm_eps), tp)


def serve_step(model: Transformer, cache: Dict[str, torch.Tensor],
               inputs: Dict[str, torch.Tensor], *, kv_quant: bool = False,
               tp: Optional[TPGroup] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole batch over a **dense** cache
    (``init_cache``, with ``kv_quant`` as it was made), on the model's
    device.

    inputs: token [B] (audio [B, codebooks]) and pos [B] int32, each
    sequence's position of the new token (continuous batching: rows may
    differ).  Each layer writes the new K/V IN PLACE at ``pos`` (clipped
    to the cache, as the reference's ``dynamic_update_slice`` clips) and
    attends over positions <= pos within its ``layer_windows`` window:
    ``kernels.ops.flash_decode`` (``flash_decode_quant`` over an int8
    cache), MLA's latent cache through ``kernels.ops.mla_decode``.
    gemma2's split cache runs its layers in (local, global) pairs, as
    the reference's pair scan: the local layer over its ring
    (``attn_decode_ring``), the global one over its full cache.  RWKV6
    and zamba2 step their recurrences (``_rwkv6_step``,
    ``_zamba2_step``).
    Returns (logits [B, V] (audio [B, codebooks, V]), cache) — the
    cache's tensors are the same, updated in place.

    ``tp``: a rank's model (``tensor_parallel.shard_model``) with its
    ``model`` group, over the rank's block of the cache (its KV heads, or
    all of them where they do not split; ``shard_cache``), GQA decoders
    only: ``flash_decode`` (or ``flash_decode_quant``) at the rank's
    head counts, the logits gathered whole on every rank.
    """
    cfg = model.cfg
    tp = bind(model, tp, "serve_step")
    pos = inputs["pos"]
    B = pos.shape[0]
    rows = torch.arange(B, device=pos.device)          # write index, once a step
    clip = lambda S: pos.long().clamp(0, S - 1)
    kind = family_kind(cfg)
    if kind == "rwkv6":
        return _rwkv6_step(model, cache, inputs["token"]), cache
    if kind == "zamba2":
        return _zamba2_step(model, cache, inputs["token"], pos, rows,
                            clip(cache["shared_k"].shape[2])), cache

    if cfg.local_global_pattern and cfg.sliding_window:
        kl, vl = cache["k_local"], cache["v_local"]
        kg, vg = cache["k_global"], cache["v_global"]
        W = kl.shape[2]
        slot = pos.long() % W
        ring_pos = torch.clamp(pos, max=W - 1)
        at = clip(kg.shape[2])

        def attend(l, lp, a_in):
            i = l // 2
            if l % 2 == 0:
                return attn.attn_decode_ring(lp, a_in, cfg, kl[i], vl[i], pos,
                                             rows, slot, ring_pos)
            if kv_quant:
                return attn.attn_decode_quant(
                    lp, a_in, cfg, kg[i], vg[i], cache["k_global_scale"][i],
                    cache["v_global_scale"][i], pos, rows, at)
            return attn.attn_decode(lp, a_in, cfg, kg[i], vg[i], pos, rows, at)

    elif cfg.attn_kind == "mla":
        ckv, kpe = cache["ckv"], cache["kpe"]
        at = clip(ckv.shape[2])

        def attend(l, lp, a_in):
            return mla.mla_decode(lp, a_in, cfg, ckv[l], kpe[l], pos, rows, at)

    else:
        ck, cv = cache["k"], cache["v"]
        at = clip(ck.shape[2])
        windows = layer_windows(cfg)

        def attend(l, lp, a_in):
            if kv_quant:
                return attn.attn_decode_quant(
                    lp, a_in, cfg, ck[l], cv[l], cache["k_scale"][l],
                    cache["v_scale"][l], pos, rows, at, windows[l], tp=tp)
            return attn.attn_decode(lp, a_in, cfg, ck[l], cv[l], pos, rows, at,
                                    windows[l], tp=tp)

    return _decode(model, inputs["token"], attend, tp), cache


def _rwkv6_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor) -> torch.Tensor:
    """One RWKV6 token a row: each layer's time mix and channel mix
    from its shifts and wkv state, which are overwritten in place with
    the new ones (the reference's scan returns them).  Returns logits
    [B, V]."""
    cfg = model.cfg
    s1, wkv, s2 = cache["shift1"], cache["wkv"], cache["shift2"]
    h = embed_tokens(model, tokens)                      # [B, d]
    for l in range(cfg.num_layers):
        lp = model.layer(l)
        y, s1o, st = rwkv6.rwkv6_time_mix_step(
            lp, rms_norm(h, lp["tm_norm"], cfg.norm_eps), cfg,
            shift_in=s1[l], state_in=wkv[l])
        h = h + y
        y, s2o = rwkv6.rwkv6_channel_mix(
            lp, rms_norm(h, lp["cm_norm"], cfg.norm_eps), s2[l])
        h = h + y
        s1[l].copy_(s1o)
        wkv[l].copy_(st)
        s2[l].copy_(s2o)
    return unembed(model, rms_norm(h, model.final_norm, cfg.norm_eps))


def _zamba2_step(model: Transformer, cache: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
                 at: torch.Tensor) -> torch.Tensor:
    """One zamba2 token a row: for each group, the shared block's
    attention over its dense K/V (written in place at (``rows``,
    ``at``), ``attn_decode``, so one ``flash_decode`` grid a group) and
    its MLP, then the group's Mamba2 steps, whose conv inputs and SSD
    states are overwritten in place.  Returns logits [B, V]."""
    cfg = model.cfg
    G, per = zamba2_groups(cfg)
    ck, cv, conv, ssd = (cache[n] for n in ("shared_k", "shared_v", "conv",
                                            "ssd"))
    h = embed_tokens(model, tokens)                      # [B, d]
    for g in range(G):
        ap, mp = shared_block(model, g)
        h = h + attn.attn_decode(
            ap, rms_norm(h, model.shared_attn_norm, cfg.norm_eps), cfg,
            ck[g], cv[g], pos, rows, at)
        h = _shared_mlp(model, mp, h)
        for i in range(per):
            lp = model.layer(g * per + i)
            y, co, st = mamba2.mamba2_step(
                lp, rms_norm(h, lp["norm"], cfg.norm_eps), cfg,
                conv_in=conv[g, i], state_in=ssd[g, i])
            h = h + y
            conv[g, i].copy_(co)
            ssd[g, i].copy_(st)
    return unembed(model, rms_norm(h, model.final_norm, cfg.norm_eps))


def _check_paged(cfg: ArchConfig) -> None:
    """Paged decode takes global-causal GQA attention decoders only (the
    reference's ``supports_paged_decode``): no window, no MLA, no
    recurrent family."""
    if (family_kind(cfg) != "attn" or cfg.attn_kind != "gqa"
            or cfg.sliding_window):
        raise ValueError(f"arch {cfg.name!r} decodes over a dense cache "
                         "only (sliding window, MLA or a recurrent family)")


def serve_step_paged(model: Transformer, k_slab: torch.Tensor,
                     v_slab: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, inputs: Dict[str, torch.Tensor],
                     *, tp: Optional[TPGroup] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over **paged** (block-table) KV.

    k_slab/v_slab: the ``KVPageSlab`` tensors [L, NP, ps, KVH, Dh];
    block_table: [B, max_blocks] int32 slab page slots; lengths: [B]
    int32 tokens already written per sequence, on the model's device.
    The new token's K/V is written IN PLACE at position ``lengths``
    (``slot = block_table[b, lengths // ps]``, ``off = lengths % ps``)
    before attention runs over ``lengths + 1`` tokens with
    ``kernels.ops.flash_decode_paged``; the caller advances the lease's
    lengths afterwards.  inputs: token [B] (audio [B, codebooks]).

    Returns (logits [B, V] (audio [B, codebooks, V]), k_slab, v_slab) —
    the slabs are the same tensors, updated in place.

    ``tp``: a rank's model with its ``model`` group over the rank's
    slab [L, NP, ps, KVH / model, Dh] (``shard_cache``; every KV head
    where they do not split), the same block table and lengths on every
    rank: ``flash_decode_paged`` at the rank's head counts.
    """
    cfg = model.cfg
    _check_paged(cfg)
    tp = bind(model, tp, "serve_step_paged")
    ps = k_slab.shape[2]
    lens = lengths.long()
    slot = block_table.long().gather(1, (lens // ps)[:, None])[:, 0]
    off = lens % ps
    attn_len = (lengths + 1).to(torch.int32)

    def attend(l, lp, a_in):
        return attn.attn_decode_paged(lp, a_in, cfg, k_slab[l], v_slab[l],
                                      block_table, lengths, slot, off,
                                      attn_len, tp=tp)

    return _decode(model, inputs["token"], attend, tp), k_slab, v_slab


def serve_step_paged_spliced(model: Transformer, k_slab: torch.Tensor,
                             v_slab: torch.Tensor, block_table: torch.Tensor,
                             lengths: torch.Tensor, page_delta: torch.Tensor,
                             page_valid: torch.Tensor,
                             inputs: Dict[str, torch.Tensor],
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``serve_step_paged`` over a block table that mixes fresh pages with
    **spliced** chunk-KV pages (reordered RoPE, TurboRAG).

    Spliced pages hold K/V prefilled offline at chunk-local positions and
    attach by block-table edit (``KVCacheManager.splice_paged``): at
    attention time each page's stored K is rotated by its constant layout
    offset ``page_delta`` [B, MB] and the dead tail of a chunk's partial
    last page is masked by ``page_valid`` [B, MB] live-token counts;
    fresh pages carry delta 0 and valid ``ps``, so an all-fresh table
    gives ``serve_step_paged``'s numbers.  The new token is rotated and
    written IN PLACE at layout position ``lengths`` as there, and
    attention runs over ``lengths + 1`` layout positions with
    ``kernels.ops.flash_decode_spliced``.  Returns (logits [B, V],
    k_slab, v_slab), the slabs updated in place.  Unsharded models only
    (a rank's model raises).
    """
    cfg = model.cfg
    _check_paged(cfg)
    bind(model, None, "serve_step_paged")
    ps = k_slab.shape[2]
    lens = lengths.long()
    slot = block_table.long().gather(1, (lens // ps)[:, None])[:, 0]
    off = lens % ps
    attn_len = (lengths + 1).to(torch.int32)

    def attend(l, lp, a_in):
        return attn.attn_decode_spliced(lp, a_in, cfg, k_slab[l], v_slab[l],
                                        block_table, lengths, page_delta,
                                        page_valid, slot, off, attn_len)

    return _decode(model, inputs["token"], attend), k_slab, v_slab
