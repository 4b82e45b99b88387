"""Nemotron-4-15B [arXiv:2402.16819; unverified] — GQA, squared-ReLU MLP."""

from repro_torch.configs.base import ArchConfig, register

NEMOTRON4_15B = register(ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819; unverified",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=256_000,
    attn_kind="gqa",
    mlp_act="relu2",          # squared ReLU
    mlp_gated=False,          # plain up/down MLP
    rope_fraction=0.5,        # partial rotary embedding
    subquadratic=False,
))
