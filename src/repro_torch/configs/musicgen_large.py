"""MusicGen-Large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

The modality frontend (EnCodec) is a stub: ``input_specs()`` supplies token
ids for 4 parallel codebooks (vocab 2048 each). Codebook embeddings are
summed on the way in; the model emits 4 parallel heads on the way out. The
codebook delay pattern is handled in the trace layer, not the backbone.
"""

from repro_torch.configs.base import ArchConfig, FrontendConfig, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284; hf",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,              # per-codebook vocabulary
    attn_kind="gqa",
    frontend=FrontendConfig(
        kind="encodec_stub",
        num_codebooks=4,
    ),
    mlp_act="gelu",
    mlp_gated=False,
    subquadratic=False,
))
