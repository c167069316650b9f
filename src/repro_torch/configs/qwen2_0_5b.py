"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
24L d_model=896 14H d_ff=4864 vocab=151936 [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab=151936,
    attn=AttnConfig(qkv_bias=True, rope_theta=1000000.0),
    pattern=(("attn", "dense"),),
    tie_embeddings=True,
)
