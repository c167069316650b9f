"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060]

Mamba-2 block: d_inner = 2*d_model = 3072, headdim 64 (48 heads), d_state
128, depthwise conv4, gated RMSNorm before out_proj.  No separate FFN
(d_ff=0): the block IS the layer.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, d_conv=4),
    pattern=(("mamba", "none"),),
    tie_embeddings=True,
)
