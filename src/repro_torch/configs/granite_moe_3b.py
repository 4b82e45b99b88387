"""Granite-MoE-3B-a800m [hf:ibm-granite; hf] — 40 experts top-8, tiny d_ff."""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

GRANITE_MOE_3B = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49_155,
    attn_kind="gqa",
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_ff_expert=512,
    ),
    mlp_act="silu",
    mlp_gated=True,
    subquadratic=False,
))
