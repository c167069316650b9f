"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).
28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191; hf]

Backbone only per the assignment: ``input_specs()`` provides precomputed
patch embeddings (the ViT frontend is a stub); M-RoPE splits the rotary
dims into (temporal, height, width) = (16, 24, 24) sections of head_dim/2.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    attn=AttnConfig(
        qkv_bias=True, rope_theta=1000000.0, mrope_sections=(16, 24, 24)
    ),
    pattern=(("attn", "dense"),),
    frontend_positions=256,    # precomputed vision-patch embeddings per sample
    tie_embeddings=True,
)
