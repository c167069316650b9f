"""llama4-maverick-400b-a17b [moe] — interleaved MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4; unverified]

MoE on every *second* layer (the real Maverick interleave) + one always-on
shared expert: with the listed dims this yields ~400 B total / ~17 B active
parameters, matching the model name; an all-MoE stack would be ~780 B (see
DESIGN.md §3).  Early fusion = token-space multimodal fusion; the modality
frontend is a stub providing precomputed patch embeddings.

Big-MoE memory posture: bf16 parameters and bf16 optimizer moments so
param+state fits a 16 GB/chip pod at 256 chips (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    attn=AttnConfig(rope_theta=500000.0),
    moe=MoEConfig(num_experts=128, top_k=1, d_expert=8192, interleave=2,
                  shared_expert=True),
    pattern=(("attn", "dense"), ("attn", "moe")),
    frontend_positions=256,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
)
