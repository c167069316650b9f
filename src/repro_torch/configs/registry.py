"""Architecture registry of the port: ``get_arch`` and the reduced smoke
configs (port of ``repro.configs.registry``).

Only the archs whose blocks the port's model stack runs are registered:
dense attention decoders.  The reference's other archs need MoE, Mamba,
encoder-decoder or multimodal blocks, which wait for ROADMAP A9b (and
with them ``smoke_config``'s reductions of those blocks); asking for one
raises ``KeyError`` naming that item.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import qwen2_0_5b
from repro_torch.configs.base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (qwen2_0_5b,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not in the port; it runs "
                       f"{sorted(ARCHS)} (the reference's other archs wait "
                       f"for ROADMAP A9b)")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests: small widths and layers,
    tiny vocab, float32 compute — the reference's ``smoke_config``."""
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
    return dataclasses.replace(c, **kw)
