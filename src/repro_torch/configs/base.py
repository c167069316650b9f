"""Architecture configuration dataclasses (port of ``repro.configs.base``).

The same fields and defaults as the reference, so a config built here and
one built there describe the same model.  ``MoEConfig`` and ``SSMConfig``
are plain data: the port's model stack runs dense attention blocks only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    interleave: int = 1           # MoE every Nth layer (1 = every layer)
    shared_expert: bool = False   # llama4-style always-on shared expert


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    sliding_window: Optional[int] = None     # local window (gemma2 local layers)
    local_global_period: int = 0             # 2 => alternate local/global
    logit_softcap: Optional[float] = None    # gemma2: 50.0
    qk_norm: bool = False                    # qwen3
    qkv_bias: bool = False                   # qwen2
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn: AttnConfig = AttnConfig()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # (mixer, ffn) pattern repeated to reach n_layers
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    n_encoder_layers: int = 0
    frontend_positions: int = 0
    tie_embeddings: bool = False
    final_softcap: Optional[float] = None
    act: str = "silu"                        # silu | gelu
    post_norms: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"

    @property
    def n_pattern_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)
