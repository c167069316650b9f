"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 [arXiv:2408.00118; hf]
head_dim=256, sliding window 4096, attn softcap 50, final softcap 30, GeGLU,
pre+post RMSNorm, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256000,
    attn=AttnConfig(
        sliding_window=4096,
        local_global_period=2,
        logit_softcap=50.0,
        rope_theta=10000.0,
    ),
    pattern=(("attn_local", "dense"), ("attn_global", "dense")),
    tie_embeddings=True,
    final_softcap=30.0,
    act="gelu",
    post_norms=True,
)
