"""RWKV6-3B "Finch" [arXiv:2404.05892; hf] — attention-free, data-dependent decay."""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

RWKV6_3B = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892; hf",
    num_layers=32,
    d_model=2560,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=8960,                # channel-mix width
    vocab_size=65_536,
    attn_kind="none",
    ssm=SSMConfig(
        kind="rwkv6",
        head_dim=64,          # 40 time-mix heads of 64 channels
        state_dim=64,
        chunk_size=128,
    ),
    mlp_act="relu2",          # rwkv channel-mix uses squared relu
    mlp_gated=False,
    subquadratic=True,        # O(1) decode state, linear train/prefill
))
