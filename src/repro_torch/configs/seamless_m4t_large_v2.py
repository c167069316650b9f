"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
24+24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

Backbone only: the w2v-BERT speech frontend is a STUB; ``input_specs()``
provides precomputed frame embeddings for the encoder (per the assignment).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                 # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,
    attn=AttnConfig(rope_theta=10000.0),
    pattern=(("attn", "dense"),),
    frontend_positions=1024,     # encoder frame embeddings per sample
    act="gelu",
)
