"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base; hf].

128 experts top-2 with a *dense residual* MLP in parallel (Arctic's
dense-MoE hybrid design).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base; hf",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                # per-expert FFN width
    vocab_size=32_000,
    attn_kind="gqa",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual_d_ff=4864,
    ),
    mlp_act="silu",
    mlp_gated=True,
    subquadratic=False,
))
