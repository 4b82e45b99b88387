"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf] — dense with MLA attention."""

from repro_torch.configs.base import ArchConfig, MLAConfig, register

MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B; hf",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    attn_kind="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    mlp_act="silu",
    mlp_gated=True,
    subquadratic=False,  # full attention (compressed KV, still O(S) per step)
))
