"""granite-4.0-h-small [hybrid] — Mamba-2 + NoPE GQA 9:1, MoE 72e top-10
with a shared expert, muP multipliers.

40L d_model=4096 32H (GQA kv=8) hd=128 expert d_ff=768 shared 1536
vocab=100352 tied [hf ibm-granite/granite-4.0-h-small config.json]

Period-10 pattern: Mamba-2 at positions 0-4 and 6-9, attention at 5
(``layer_types``: 36 Mamba + 4 attention layers).  Every layer's FFN is
the MoE (softmax over the top 10 of 72 router logits, the same as the
port's softmax over all 72 then renormalised top 10, up to rounding) plus
a shared SwiGLU expert of 1,536.  Mamba-2: 128 heads of 64, d_state 128,
one group, conv 4 with a bias, chunk 256.  Attention has no position
embedding and scores at ``attention_multiplier`` 1/128.  The embedding is
scaled by 12, each residual branch by 0.22, the logits divided by 16.
This is not an arch of the reference: it lives in the port's own table
(``registry.PORT_ARCHS``), with ``CONFIG_1PERIOD``, one period (10 layers),
the stage of a four-stage pipeline that one card holds.
"""
import dataclasses

from repro_torch.configs.base import (AttnConfig, MoEConfig, PortArchConfig,
                                     PortSwitches, SSMConfig)

ATTN_POSITION = 5
PERIOD = 10

CONFIG = PortArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=768,
    vocab=100352,
    attn=AttnConfig(rope_theta=10000.0),
    moe=MoEConfig(num_experts=72, top_k=10, d_expert=768, shared_expert=True),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, d_conv=4, chunk=256),
    pattern=tuple(("attn" if i == ATTN_POSITION else "mamba", "moe")
                  for i in range(PERIOD)),
    tie_embeddings=True,
    norm_eps=1e-5,
    port=PortSwitches(rope=False, score_scale=1.0 / 128, embed_scale=12.0,
                      residual_scale=0.22, logits_scaling=16.0,
                      shared_d_ff=1536, conv_bias=True),
)

CONFIG_1PERIOD = dataclasses.replace(
    CONFIG, name="granite-4.0-h-small-1period", n_layers=PERIOD)
