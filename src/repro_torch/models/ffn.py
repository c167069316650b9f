"""Gated dense feed-forward layer (SwiGLU / GeGLU), port of the dense part
of ``repro.models.ffn``.  Mixture-of-Experts, like the port's other
unported blocks, waits for ROADMAP A9b."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, act_fn, linear


def dense_ffn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def dense_ffn(p, x, cfg: ArchConfig):
    g = act_fn(linear(x, p["w_gate"].to(x.dtype), "w_gate"), cfg.act)
    u = linear(x, p["w_up"].to(x.dtype), "w_up")
    return linear(g * u, p["w_down"].to(x.dtype), "w_down")
