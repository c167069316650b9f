"""Architecture registry of the port: ``get_arch``, the reduced smoke
configs and the training microbatch counts (port of
``repro.configs.registry``).

All ten archs of the reference are registered in ``ARCHS``, as plain
data: their parameter counts drive the closed-form decode mapping
(``imc.mapping``), and ``models.model`` builds every one of them.
``PORT_ARCHS`` holds the archs only the port has (granite-4.0-h-small and
its one-period stage); ``get_arch`` and ``smoke_config`` answer from both
tables, while ``ARCHS`` stays the reference's ten.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.configs import (
    gemma2_2b,
    granite_4_0_h_small,
    internlm2_20b,
    jamba_1_5_large_398b,
    llama4_maverick_400b_a17b,
    mamba2_780m,
    olmoe_1b_7b,
    qwen2_0_5b,
    qwen2_vl_2b,
    qwen3_8b,
    seamless_m4t_large_v2,
)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma2_2b,
        internlm2_20b,
        qwen2_0_5b,
        qwen3_8b,
        qwen2_vl_2b,
        llama4_maverick_400b_a17b,
        olmoe_1b_7b,
        seamless_m4t_large_v2,
        mamba2_780m,
        jamba_1_5_large_398b,
    )
}

PORT_ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (granite_4_0_h_small.CONFIG,
                        granite_4_0_h_small.CONFIG_1PERIOD)
}

# Recommended grad-accumulation microbatch counts for train_4k at the
# (data=16, model=16) production mesh (DESIGN.md §4).
TRAIN_MICROBATCHES: Dict[str, int] = {
    "gemma2-2b": 4,
    "internlm2-20b": 8,
    "qwen2-0.5b": 2,
    "qwen3-8b": 4,
    "qwen2-vl-2b": 2,
    "llama4-maverick-400b-a17b": 8,
    "olmoe-1b-7b": 2,
    "seamless-m4t-large-v2": 2,
    "mamba2-780m": 2,
    "jamba-1.5-large-398b": 16,
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; choose from "
                   f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests: small widths/layers, tiny
    vocab, few experts, float32 compute — same pattern and feature flags as
    the original (the reference's ``smoke_config``)."""
    c = get_arch(name)
    kw = dict(
        name=c.name + "-smoke",
        n_layers=len(c.pattern) * (2 if len(c.pattern) <= 4 else 1),
        d_model=64,
        n_heads=4 if c.n_heads else 0,
        n_kv_heads=min(c.n_kv_heads, 2) if c.n_kv_heads else 0,
        d_head=16 if c.n_heads else 0,
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        n_encoder_layers=2 if c.n_encoder_layers else 0,
        frontend_positions=8 if c.frontend_positions else 0,
        param_dtype="float32",
        opt_state_dtype="float32",
        compute_dtype="float32",
    )
    if c.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4,
            top_k=min(c.moe.top_k, 2),
            d_expert=64,
            interleave=c.moe.interleave,
            shared_expert=c.moe.shared_expert,
        )
        if c.port.shared_d_ff is not None:
            # the shared expert at a width of its own, as the arch has it
            kw["port"] = dataclasses.replace(c.port, shared_d_ff=96)
    if c.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, headdim=16, expand=2, d_conv=4,
                              chunk=8)
    if c.attn.mrope_sections is not None:
        kw["attn"] = dataclasses.replace(c.attn, mrope_sections=(2, 3, 3))
    if c.attn.sliding_window is not None:
        att = kw.get("attn", c.attn)
        kw["attn"] = dataclasses.replace(att, sliding_window=8)
    return dataclasses.replace(c, **kw)
