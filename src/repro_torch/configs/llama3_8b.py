"""Llama-3-8B [arXiv:2407.21783] — the paper's own evaluation model.

TeleRAG's single-GPU latency and H100 throughput experiments use
Llama-3.2-3B / Llama-3-8B / Mistral-22B; we carry the 8B as the
paper-faithful reference generator for the RAG benchmarks.
"""

from repro_torch.configs.base import ArchConfig, register

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783; hf (paper's evaluation model)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    attn_kind="gqa",
    rope_theta=500_000.0,
    mlp_act="silu",
    mlp_gated=True,
    subquadratic=False,
))
