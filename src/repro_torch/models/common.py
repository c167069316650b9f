"""Model substrate of the port: parameter specs and init, the linear
interception hook, norms, activations and rotary embeddings (port of
``repro.models.common``).

Parameter handling is spec-first, as the reference's: ``init_params``
draws concrete tensors, ``abstract_params`` gives the same tree on the
meta device (shapes and dtypes, no storage) and ``logical_axes`` the tree
of each spec's logical axis names, which ``launch.sharding`` maps to mesh
axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig

_F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names
    init: str = "normal"                  # normal | zeros | ones | embed
    dtype: Optional[str] = None           # override cfg.param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(specs: Any, cfg: ArchConfig, generator: torch.Generator,
                device) -> Any:
    """Concrete parameters from the specs: N(0, 1/fan_in) weights, N(0, 1/d)
    embeddings, zeros / ones — the reference's scheme, drawn from
    ``generator`` (on ``device``) in the reference's leaf order."""
    def mk(spec: ParamSpec):
        dtype = DTYPES[spec.dtype or cfg.param_dtype]
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = (spec.shape[0] if len(spec.shape) > 1
                  else max(spec.shape[-1], 1))
        if spec.init == "embed":
            scale = 1.0 / math.sqrt(spec.shape[-1])
        else:
            scale = 1.0 / math.sqrt(fan_in)
        z = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=_F32)
        return (z * scale).to(dtype)

    return tree_map(mk, specs)


def abstract_params(specs: Any, cfg: ArchConfig) -> Any:
    """The parameter tree on ``torch.device("meta")``: each spec's shape in
    its dtype (``spec.dtype or cfg.param_dtype``)."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=DTYPES[s.dtype or cfg.param_dtype], device="meta"),
        specs)


def logical_axes(specs: Any) -> Any:
    """The tree of each spec's logical axis names (one tuple per leaf)."""
    return tree_map(lambda s: s.axes, specs)


# --------------------------------------------------------------------------
# linear-layer interception (analog IMC routing — DESIGN.md §12)
# --------------------------------------------------------------------------
# Every crossbar-mappable product of the model stack goes through ``linear``
# so ``imc.model_analog`` can reroute it through the analog MVM.  The hook
# is a module global: the forward is eager and single-threaded.
_LINEAR_HOOK = None


def linear(x: torch.Tensor, w: torch.Tensor, tag: str = "") -> torch.Tensor:
    """``x @ w`` with optional interception: the hook receives a 2-D
    ``(M, K)`` view plus the site tag and returns ``(M, N)``."""
    if _LINEAR_HOOK is None:
        return x @ w
    lead = x.shape[:-1]
    y = _LINEAR_HOOK(x.reshape(-1, x.shape[-1]), w, tag)
    return y.reshape(*lead, w.shape[-1])


class intercept_linears:
    """Context manager installing ``hook(x2d, w, tag) -> y2d`` on ``linear``."""

    def __init__(self, hook):
        self.hook = hook

    def __enter__(self):
        global _LINEAR_HOOK
        self._prev = _LINEAR_HOOK
        _LINEAR_HOOK = self.hook
        return self

    def __exit__(self, *exc):
        global _LINEAR_HOOK
        _LINEAR_HOOK = self._prev
        return False


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(_F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(_F32))).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


# --------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    e = torch.arange(0, half, dtype=_F32, device=device) / float(half)
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x (B, S, H, D) rotated by ``positions`` (B, S), or (3, B, S) with
    M-RoPE sections."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (D/2,)
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions[..., None].to(_F32) * freqs  # (B,S,D/2)
    else:
        if positions.dim() == 2:
            positions = torch.broadcast_to(positions[None],
                                           (3,) + tuple(positions.shape))
        parts = []
        start = 0
        for sec, pos in zip(mrope_sections, positions):
            parts.append(pos[..., None].to(_F32) * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)
    cos = torch.cos(angles)[..., None, :]               # (B,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
