"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf]

Period-8 pattern: 1 attention layer + 7 Mamba layers; MoE FFN every second
layer (dense otherwise).  Long-context capable: only the 9 attention layers
hold a KV cache — the long_500k cell runs for this arch (DESIGN.md §3).
Big-MoE memory posture: bf16 params + bf16 optimizer moments.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    attn=AttnConfig(rope_theta=10000.0),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, interleave=2),
    ssm=SSMConfig(d_state=128, headdim=128, expand=2, d_conv=4),
    pattern=(
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
)
