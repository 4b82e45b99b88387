"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention blocks."""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

ZAMBA2_2_7B = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    attn_kind="gqa",          # flavour of the *shared* attention block
    ssm=SSMConfig(
        kind="mamba2",
        state_dim=64,
        head_dim=64,
        conv_width=4,
        expand=2,
        chunk_size=128,
    ),
    # one shared attention(+MLP) block applied every 6 mamba blocks, with
    # per-application LoRA deltas (Zamba2's parameter-sharing design).
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    mlp_act="gelu",
    mlp_gated=True,
    subquadratic=True,        # mamba state + periodic attention
))
