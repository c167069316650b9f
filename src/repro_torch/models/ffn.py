"""Feed-forward layers (port of ``repro.models.ffn``): the gated dense FFN
(SwiGLU / GeGLU) and GShard-style Mixture-of-Experts with capacity.

MoE: tokens are grouped (``MOE_GROUP`` per group) and each choice takes a
slot of its expert by a position-in-expert cumsum over the flattened
(token, choice) order, as in the reference.  From the routing, integer
tables (``Routes``) map slots to tokens and tokens to slots: the dispatch
is a row gather straight into the experts' (E, G, C, d) layout, and the
return is each token's gate-weighted sum of its kept slots, in float32
and in ascending expert order.  The reference builds a (Tg, E, C) one-hot
combine tensor and runs both as einsums; the results agree to rounding
(the dispatch is the same copy).  The aux loss (Switch load-balance +
router z-loss) is returned beside the output.  The router and the expert
products are plain ``@`` / ``einsum``, as in the reference: they do not
pass through the ``linear`` hook, so the analog path leaves them exact
(only a shared expert, a dense FFN, is routed).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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
    """SwiGLU / GeGLU; each weight is cast to its own product's input dtype
    (under an analog hook that returns float32, ``g * u`` is float32
    whatever ``x`` is)."""
    g = act_fn(linear(x, p["w_gate"].to(x.dtype), "w_gate"), cfg.act)
    u = linear(x, p["w_up"].to(x.dtype), "w_up")
    m = g * u
    return linear(m, p["w_down"].to(m.dtype), "w_down")


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """Router (float32 whatever the parameter dtype), stacked experts
    (E, d, f) / (E, f, d) and, with ``shared_expert``, a dense FFN of
    ``cfg.shared_width`` (the expert width unless the arch sets its own).
    The reference's ``REPRO_MOE_2D`` changes only sharding axes, never
    shapes."""
    assert cfg.moe is not None
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    sp = {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype="float32"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.moe.shared_expert:
        fs = cfg.shared_width
        sp["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "ffn")),
            "w_up": ParamSpec((d, fs), ("embed", "ffn")),
            "w_down": ParamSpec((fs, d), ("ffn", "embed")),
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


class Routes(NamedTuple):
    """A MoE call's routing as index tables.  Slots are numbered in the
    experts' (E, G, C) order, tokens over the n = G x Tg rows of the
    layer's input.  A choice fills a slot when it is within capacity and
    its gate is > 0; a sentinel, one past the last slot, token or choice,
    marks an empty slot or a dropped choice."""
    slot_token: torch.Tensor    # (E G C,) the token in each slot, or n
    slot_choice: torch.Tensor   # (E G C,) its choice, flat over (n, k), or nk
    token_slot: torch.Tensor    # (n, k) each choice's slot, or E G C; a
                                # token's choices in ascending expert order
    gates: torch.Tensor         # (n, k) in token_slot's order, 0 if dropped


def _routes(expert_idx, pos, gate_vals, e: int, cap: int) -> Routes:
    G, tg, k = expert_idx.shape
    n, slots = G * tg, e * G * cap
    dev = expert_idx.device
    group = torch.arange(G, device=dev)[:, None, None]
    slot = (expert_idx * G + group) * cap + pos.to(torch.long)
    slot = torch.where(gate_vals > 0.0, slot, slots).reshape(n, k)
    # a token's slots ascend with its experts: sorting them orders its
    # choices by expert, dropped ones last
    token_slot, order = torch.sort(slot, dim=-1)
    gates = torch.gather(gate_vals.reshape(n, k), 1, order)
    # every dropped choice writes the sentinel entry, which is cut off
    slot_choice = torch.full((slots + 1,), n * k, dtype=torch.long,
                             device=dev).scatter_(
        0, token_slot.reshape(-1), torch.arange(n * k, device=dev))[:slots]
    return Routes(slot_choice // k, slot_choice, token_slot, gates)


def _weighted_rows(rows, index, weights, dtype):
    """``out[i] = sum_j weights[i, j] rows[index[i, j]]`` over the j whose
    index is a row (a sentinel, past the last row, adds nothing): products
    and sums in float32, j ascending, rounded once to ``dtype``."""
    m, k = index.shape
    held = index < rows.shape[0]
    picked = rows.index_select(0, torch.where(held, index, 0).reshape(-1))
    picked = picked.view(m, k, -1)
    w = torch.where(held, weights.to(_F32), 0.0)[..., None]
    out = picked[:, 0] * w[:, 0]
    for j in range(1, k):
        out.addcmul_(picked[:, j], w[:, j])
    return out.to(dtype)


class MoEDispatch(torch.autograd.Function):
    """x (n, d) -> each slot's token row (E G C, d), zero in an empty slot:
    a copy.  The backward sums each token's kept slot rows through the
    token -> slot table, in a fixed order (no atomics)."""

    @staticmethod
    def forward(ctx, x, routes: Routes):
        ctx.save_for_backward(routes.token_slot)
        rows = torch.nn.functional.pad(x, (0, 0, 0, 1))
        return rows.index_select(0, routes.slot_token)

    @staticmethod
    def backward(ctx, grad):
        token_slot, = ctx.saved_tensors
        ones = torch.ones_like(token_slot, dtype=_F32)
        return _weighted_rows(grad, token_slot, ones, grad.dtype), None


class MoECombine(torch.autograd.Function):
    """ye (E G C, d), gates (n, k) -> y (n, d): each token's gate-weighted
    sum of its kept slot rows (``_weighted_rows``).  The backward takes
    gate x grad_y[token] into each slot through the slot -> token table,
    and each kept gate's row dot product, so nothing is summed by
    atomics."""

    @staticmethod
    def forward(ctx, ye, gates, routes: Routes):
        ctx.save_for_backward(ye, gates, routes.slot_token,
                              routes.slot_choice, routes.token_slot)
        return _weighted_rows(ye, routes.token_slot, gates, ye.dtype)

    @staticmethod
    def backward(ctx, grad):
        ye, gates, slot_token, slot_choice, token_slot = ctx.saved_tensors
        n, k = token_slot.shape
        slot_gate = torch.nn.functional.pad(gates.reshape(-1), (0, 1))[
            slot_choice]
        g_ye = _weighted_rows(grad, slot_token[:, None], slot_gate[:, None],
                              ye.dtype)
        held = token_slot < ye.shape[0]
        picked = ye.index_select(0, torch.where(held, token_slot, 0).reshape(
            -1)).view(n, k, -1)
        g_gates = torch.sum(picked.to(_F32) * grad.to(_F32)[:, None], dim=-1)
        return g_ye, torch.where(held, g_gates, 0.0).to(gates.dtype), None


def moe_route(p, x, cfg: ArchConfig):
    """The router half of ``moe_ffn``: (logits, probs, expert indices,
    the one-hot choices sel (G, Tg, k, E), the routing tables ``Routes``,
    kept mask)."""
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
    routes = _routes(expert_idx, pos, gate_vals, e, cap)
    return logits, probs, expert_idx, sel, routes, keep


def moe_ffn(p, x, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).  x: (B, S, d)."""
    B, S, d = x.shape
    e = cfg.moe.num_experts
    logits, probs, _, sel, routes, _ = moe_route(p, x, cfg)
    G = sel.shape[0]
    # the aux loss comes before the expert products: a recompute region's
    # backward re-runs its forward up to the last op that saves a tensor,
    # so the last product (the return, or the shared expert's down
    # projection, the larger of the two) is not re-run; the reference's
    # remat drops both (ROADMAP C20)
    me = torch.mean(probs, dim=1)                                # (G,E)
    ce = torch.mean(sel.sum(dim=2), dim=1)                       # (G,E)
    lb = e * torch.mean(torch.sum(me * ce, dim=-1))
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = 0.01 * lb + 0.001 * zl

    xe = MoEDispatch.apply(x.reshape(-1, d), routes).view(e, G, -1, d)
    h_g = act_fn(torch.einsum("egcd,edf->egcf", xe,
                              p["w_gate"].to(x.dtype)), cfg.act)
    h_u = torch.einsum("egcd,edf->egcf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("egcf,efd->egcd", h_g * h_u, p["w_down"].to(x.dtype))
    y = MoECombine.apply(ye.reshape(-1, d), routes.gates.to(x.dtype), routes)
    y = y.reshape(B, S, d)
    if cfg.moe.shared_expert:
        y = y + dense_ffn(p["shared"], x, cfg)
    return y, aux
