"""internlm2-20b [dense] — GQA. 48L d_model=6144 48H (kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92544,
    attn=AttnConfig(rope_theta=1000000.0),
    pattern=(("attn", "dense"),),
)
