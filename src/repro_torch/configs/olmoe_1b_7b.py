"""olmoe-1b-7b [moe] — 64 experts top-8, all-MoE layers.
16L d_model=2048 16H (kv=16) d_ff(expert)=1024 vocab=50304 [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    attn=AttnConfig(qk_norm=True, rope_theta=10000.0),
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    pattern=(("attn", "moe"),),
)
