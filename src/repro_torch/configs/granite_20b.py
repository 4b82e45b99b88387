"""Granite-20B-code [arXiv:2405.04324; hf] — llama-arch with MQA (kv=1)."""

from repro_torch.configs.base import ArchConfig, register

GRANITE_20B = register(ArchConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324; hf",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,           # multi-query attention
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    attn_kind="gqa",
    # GPT-BigCode lineage: plain (non-gated) GELU MLP; llama-style rotary
    # attention with multi-query KV. Non-gated matches the 20B name.
    mlp_act="gelu",
    mlp_gated=False,
    subquadratic=False,
))
