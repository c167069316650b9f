"""Architecture configuration dataclasses (port of ``repro.configs.base``).

The same fields, defaults and parameter counts as the reference, so a
config built here and one built there describe the same model;
``PortArchConfig`` adds ``PortSwitches`` for the archs only the port has.
``param_count`` / ``active_param_count`` count every arch, as the
closed-form decode mapping (``imc.mapping``) needs.  ``ShapeConfig`` /
``SHAPES`` are the reference's workload shapes (sequence, global batch,
microbatches); ``shape_for`` picks one, with the microbatches overridden;
``LONG_CONTEXT_ARCHS`` the archs that run ``long_500k``.
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
class PortSwitches:
    """Switches of the archs only the port has (granite-4.0-h).  Their
    defaults change nothing.  They are not fields of ``ArchConfig``, whose
    ``port`` is this default as a class attribute: a reference arch's
    config stays the reference's, field for field; ``PortArchConfig``
    makes ``port`` a field."""
    rope: bool = True                      # False: NoPE attention
    score_scale: Optional[float] = None    # None: 1/sqrt(d_head)
    embed_scale: Optional[float] = None    # None: sqrt(d_model)
    residual_scale: float = 1.0            # each residual branch's factor
    logits_scaling: float = 1.0            # the logits' divisor
    shared_d_ff: Optional[int] = None      # shared expert's width (None: d_expert)
    conv_bias: bool = False                # a bias on the Mamba conv


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
    port = PortSwitches()       # a class attribute: see ``PortSwitches``

    @property
    def shared_width(self) -> int:
        """The shared expert's width."""
        return self.port.shared_d_ff or self.moe.d_expert

    @property
    def n_pattern_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Approximate total parameter count (for 6ND roofline math)."""
        c = self
        emb = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        per_attn = c.d_model * c.d_head * (c.n_heads + 2 * c.n_kv_heads) + (
            c.n_heads * c.d_head * c.d_model)
        per_dense_ffn = 3 * c.d_model * c.d_ff
        per_mamba = 0
        if c.ssm is not None:
            d_in = c.ssm.expand * c.d_model
            per_mamba = (
                c.d_model * (2 * d_in + 2 * c.ssm.d_state)  # in_proj(z,x,B,C)
                + d_in * c.d_model                          # out_proj
                + d_in * c.ssm.d_conv)                      # conv
            if c.port.conv_bias:
                per_mamba += d_in + 2 * c.ssm.d_state
        total = emb
        reps = self.n_pattern_repeats
        for mixer, ffn in c.pattern:
            if mixer.startswith("attn"):
                total += reps * per_attn
            elif mixer == "mamba":
                total += reps * per_mamba
            if ffn == "dense":
                total += reps * per_dense_ffn
            elif ffn == "moe":
                assert c.moe is not None
                e = c.moe.num_experts * 3 * c.d_model * c.moe.d_expert
                if c.moe.shared_expert:
                    e += 3 * c.d_model * c.shared_width
                e += c.d_model * c.moe.num_experts  # router
                total += reps * e
        if c.n_encoder_layers:
            # encoder layers + decoder cross-attention
            total += c.n_encoder_layers * (per_attn + per_dense_ffn)
            total += c.n_layers * per_attn  # cross-attn in each decoder layer
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        c = self
        full_moe = c.moe.num_experts * 3 * c.d_model * c.moe.d_expert
        act_moe = c.moe.top_k * 3 * c.d_model * c.moe.d_expert
        n_moe_layers = sum(
            self.n_pattern_repeats for _, ffn in c.pattern if ffn == "moe")
        return self.param_count() - n_moe_layers * (full_moe - act_moe)


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An arch only the port has: ``ArchConfig`` with ``port`` a field."""
    port: PortSwitches = PortSwitches()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1        # grad-accumulation steps (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Archs whose long_500k cell runs (the constant-state SSM and the sparse-KV
# hybrid); every pure full-attention arch skips it, as in the reference.
LONG_CONTEXT_ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")


def shape_for(arch: ArchConfig, shape_name: str,
              microbatches: Optional[int] = None) -> ShapeConfig:
    """``SHAPES[shape_name]``, with ``microbatches`` replaced when given
    (``arch`` is unused, as in the reference)."""
    s = SHAPES[shape_name]
    if microbatches is not None:
        s = dataclasses.replace(s, microbatches=microbatches)
    return s
