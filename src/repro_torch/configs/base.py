"""Architecture configuration system.

Every assigned architecture is a frozen ``ArchConfig`` registered under its
public id (``--arch <id>``). Configs are *data only* — the generic model
assembler in ``repro.models.transformer`` interprets them. ``reduced()``
produces the small-family config used by per-arch smoke tests; full-size
configs are only ever lowered via ShapeDtypeStructs (no allocation).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # Arctic-style dense residual MLP running in parallel with the experts.
    dense_residual_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # load-balancing auxiliary loss weight (Switch/GShard style)
    aux_loss_weight: float = 0.01
    # dispatch subgroup size: bounds capacity C = ceil(Tg*K*cf/E) so the
    # [G,Tg,E,C] dispatch tensor stays O(T_total * E * C_g) (see moe.py)
    group_size: int = 512


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Covers both RWKV6 time-mix and Mamba2 SSD parameterizations."""

    kind: str  # "rwkv6" | "mamba2"
    state_dim: int = 64        # N: per-head state size (mamba2) / head dim (rwkv6)
    head_dim: int = 64         # P: channels per head
    conv_width: int = 4        # mamba2 short conv
    expand: int = 2            # mamba2 inner expansion
    chunk_size: int = 128      # chunked-scan block length (train/prefill)


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: input_specs() supplies precomputed embeddings."""

    kind: str                  # "vit_stub" | "encodec_stub"
    num_prefix_embeddings: int = 0   # vlm: patch embeddings prepended
    embed_dim: int = 0               # incoming embedding width (projected to d_model)
    num_codebooks: int = 1           # audio: parallel EnCodec codebooks


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    source: str                # provenance string from the assignment

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None   # default: d_model // num_heads

    # attention flavour ------------------------------------------------------
    attn_kind: str = "gqa"     # gqa | mla | none
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False   # gemma2: alternate local/global
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0           # nemotron: partial rotary

    # mlp --------------------------------------------------------------------
    mlp_act: str = "silu"      # silu | gelu | relu2
    mlp_gated: bool = True     # SwiGLU/GeGLU vs plain 2-matmul MLP

    # family extensions ------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    # hybrid (zamba2): shared attention block applied every `shared_attn_every`
    # backbone blocks, with per-application LoRA deltas of this rank.
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0

    # misc -------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long_500k eligibility (sub-quadratic attention); see DESIGN.md §4.
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.attn_kind != "none"

    def param_count(self) -> int:
        """Analytic parameter count (exact for our parameterization)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d  # unembedding
        per_layer = 0
        if self.attn_kind == "gqa":
            per_layer += d * self.num_heads * hd          # Wq
            per_layer += 2 * d * self.num_kv_heads * hd   # Wk, Wv
            per_layer += self.num_heads * hd * d          # Wo
        elif self.attn_kind == "mla":
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_dim
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        if self.ssm is not None:
            s = self.ssm
            if s.kind == "rwkv6":
                # time-mix: r,k,v,g,o projections + decay/bonus params + channel-mix
                per_layer += 5 * d * d + 2 * d + self.d_ff * d * 2
            else:  # mamba2 (single-group B/C, standard ngroups=1)
                d_in = s.expand * d
                n_heads = d_in // s.head_dim
                per_layer += d * (2 * d_in + 2 * s.state_dim + n_heads)
                per_layer += d_in * d  # out proj
        if self.moe is not None:
            mo = self.moe
            per_layer += d * mo.num_experts                      # router
            per_layer += mo.num_experts * 3 * d * mo.d_ff_expert  # gated experts
            if mo.dense_residual_d_ff:
                per_layer += 3 * d * mo.dense_residual_d_ff
        elif self.d_ff and self.ssm is None or (self.ssm is not None and self.ssm.kind == "mamba2" and self.d_ff):
            pass
        # Per-layer MLP: dense/moe-attn layers only. rwkv6 counts its
        # channel-mix in its own branch; mamba2/hybrid blocks carry no MLP
        # (zamba2's MLP lives in the one shared attention block).
        if self.moe is None and self.d_ff and self.ssm is None:
            nmat = 3 if self.mlp_gated else 2
            per_layer += nmat * d * self.d_ff
        per_layer += 2 * d  # norms
        n += L * per_layer
        if self.shared_attn_every:
            n += 4 * d * d  # one shared attention block
            nmat = 3 if self.mlp_gated else 2
            n += nmat * d * self.d_ff  # shared block's MLP (counted once)
            n_apps = self.num_layers // self.shared_attn_every
            n += n_apps * self.shared_attn_lora_rank * 2 * d * 4
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        inactive = (mo.num_experts - mo.top_k) * 3 * self.d_model * mo.d_ff_expert
        return full - self.num_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim is not None or self.attn_kind == "gqa" else None,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                dense_residual_d_ff=64 if self.moe.dense_residual_d_ff else None)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)
            kw["head_dim"] = None
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk_size=16)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(
                self.frontend,
                num_prefix_embeddings=min(self.frontend.num_prefix_embeddings, 8) or 0,
                embed_dim=min(self.frontend.embed_dim, 64) if self.frontend.embed_dim else 0)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
            kw["shared_attn_lora_rank"] = 8
            kw["num_layers"] = 4
        if self.sliding_window:
            kw["sliding_window"] = 8
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import the ported arch modules for registration side effects
    from repro_torch.configs import llama3_8b  # noqa: F401
