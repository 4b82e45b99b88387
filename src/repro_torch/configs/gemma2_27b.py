"""Gemma2-27B [arXiv:2408.00118; hf] — dense, local/global alternating, softcaps."""

from repro_torch.configs.base import ArchConfig, register

GEMMA2_27B = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118; hf",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    attn_kind="gqa",
    sliding_window=4_096,
    local_global_pattern=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="gelu",
    mlp_gated=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    # half the layers are 4096-token sliding window; global-layer KV is
    # sequence-sharded for long_500k (DESIGN.md §4).
    subquadratic=True,
))
