"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT frontend (stub) + InternLM2 backbone."""

from repro_torch.configs.base import ArchConfig, FrontendConfig, register

INTERNVL2_1B = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    attn_kind="gqa",
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(
        kind="vit_stub",
        num_prefix_embeddings=256,   # InternViT patch embeddings after pixel-unshuffle
        embed_dim=1024,              # InternViT-300M hidden width, projected to d_model
    ),
    mlp_act="silu",
    mlp_gated=True,
    subquadratic=False,
))
