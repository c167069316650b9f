"""qwen3-8b [dense] — qk_norm, GQA kv=8.
36L d_model=4096 32H d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab=151936,
    attn=AttnConfig(qk_norm=True, rope_theta=1000000.0),
    pattern=(("attn", "dense"),),
)
