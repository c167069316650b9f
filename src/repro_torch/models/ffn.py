"""Feed-forward layers (port of ``repro.models.ffn``): the gated dense FFN
(SwiGLU / GeGLU) and GShard-style Mixture-of-Experts with capacity.

MoE: tokens are grouped (``MOE_GROUP`` per group), each group builds a
(Tg, E, C) combine tensor from a position-in-expert cumsum over the
flattened (token, choice) order, and dispatch / return are einsums.  The
aux loss (Switch load-balance + router z-loss) is returned beside the
output.  The router and the expert products are plain ``@`` / ``einsum``,
as in the reference: they do not pass through the ``linear`` hook, so the
analog path leaves them exact (only a shared expert, a dense FFN, is
routed).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, act_fn, linear

MOE_GROUP = 1024          # tokens per dispatch group
CAPACITY_FACTOR = 1.25
_F32 = torch.float32


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


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """Router (float32 whatever the parameter dtype), stacked experts
    (E, d, f) / (E, f, d) and, with ``shared_expert``, a dense FFN of the
    expert width.  The reference's ``REPRO_MOE_2D`` changes only sharding
    axes, never shapes."""
    assert cfg.moe is not None
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    sp = {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype="float32"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.moe.shared_expert:
        sp["shared"] = {
            "w_gate": ParamSpec((d, f), ("embed", "ffn")),
            "w_up": ParamSpec((d, f), ("embed", "ffn")),
            "w_down": ParamSpec((f, d), ("ffn", "embed")),
        }
    return sp


def moe_capacity(tg: int, k: int, e: int) -> int:
    """Slots per expert and group: dropless (tg * k) for groups of at most
    64 tokens (decode, smoke), else ``max(4, int(tg k 1.25 / e))``, so a
    larger prefill drops tokens, as the reference does."""
    if tg <= 64:
        return tg * k
    return max(4, int(tg * k * CAPACITY_FACTOR / e))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none):
    a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, x, cfg: ArchConfig):
    """The router half of ``moe_ffn``: (logits, probs, expert indices,
    gates after the capacity mask, combine (G, Tg, E, C), kept mask)."""
    B, S, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    tg = min(MOE_GROUP, B * S)
    assert (B * S) % tg == 0, (B, S, tg)
    G = (B * S) // tg
    cap = moe_capacity(tg, k, e)

    xt = x.reshape(G, tg, d)
    logits = (xt.to(_F32) @ p["router"]).to(_F32)                # (G,Tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                      # (G,Tg,k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    # position-in-expert via cumsum over the flattened (token, k) choices
    sel = torch.nn.functional.one_hot(expert_idx, e).to(_F32)    # (G,Tg,k,E)
    sel_flat = sel.reshape(G, tg * k, e)
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat
    pos = torch.sum(pos * sel_flat, dim=-1).reshape(G, tg, k)    # (G,Tg,k)
    keep = pos < cap
    gate_vals = gate_vals * keep

    slots = torch.arange(cap, device=x.device, dtype=_F32)
    pos_oh = (pos[..., None] == slots).to(_F32) * keep[..., None]
    # combine[g,t,e,c] = gate for token t's slot c of expert e
    combine = torch.einsum("gtke,gtkc->gtec", sel,
                           pos_oh * gate_vals[..., None])
    return logits, probs, expert_idx, sel, combine, keep


def moe_ffn(p, x, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).  x: (B, S, d)."""
    B, S, d = x.shape
    e = cfg.moe.num_experts
    logits, probs, _, sel, combine, _ = moe_route(p, x, cfg)
    G, tg = combine.shape[:2]
    xt = x.reshape(G, tg, d)
    # the aux loss comes before the expert products: a recompute region's
    # backward re-runs its forward up to the last op that saves a tensor,
    # so the last product (the return einsum, or the shared expert's down
    # projection, the larger of the two) is not re-run; the reference's
    # remat drops both (ROADMAP C20)
    me = torch.mean(probs, dim=1)                                # (G,E)
    ce = torch.mean(sel.sum(dim=2), dim=1)                       # (G,E)
    lb = e * torch.mean(torch.sum(me * ce, dim=-1))
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = 0.01 * lb + 0.001 * zl

    dispatch = (combine > 0.0).to(x.dtype)
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xt)            # (E,G,C,d)
    h_g = act_fn(torch.einsum("egcd,edf->egcf", xe,
                              p["w_gate"].to(x.dtype)), cfg.act)
    h_u = torch.einsum("egcd,edf->egcf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("egcf,efd->egcd", h_g * h_u, p["w_down"].to(x.dtype))
    y = torch.einsum("egcd,gtec->gtd", ye, combine.to(x.dtype))
    y = y.reshape(B, S, d)
    if cfg.moe.shared_expert:
        y = y + dense_ffn(p["shared"], x, cfg)
    return y, aux
