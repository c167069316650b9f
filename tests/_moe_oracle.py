"""The port's MoE FFN as it ran before it routed by index: a (G, Tg, E, C)
one-hot combine tensor, and the dispatch and the return as einsums over
it.  ``tests/test_torch_moe_ssm.py`` (CPU) and ``tests/test_torch_moe_cuda.py``
(the card) hold ``models.ffn.moe_ffn`` to it.  Plain PyTorch, no JAX."""
import torch

from repro_torch.models import ffn as TF
from repro_torch.models.common import act_fn

F32 = torch.float32


def one_hot_moe(p, x, cfg):
    """(output, aux loss, xe): ``moe_ffn``'s results and its dispatched
    rows (E, G, C, d), by one-hot einsums."""
    B, S, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    tg = min(TF.MOE_GROUP, B * S)
    G = (B * S) // tg
    cap = TF.moe_capacity(tg, k, e)

    xt = x.reshape(G, tg, d)
    logits = (xt.to(F32) @ p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = TF.top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    sel = torch.nn.functional.one_hot(expert_idx, e).to(F32)
    sel_flat = sel.reshape(G, tg * k, e)
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat
    pos = torch.sum(pos * sel_flat, dim=-1).reshape(G, tg, k)
    keep = pos < cap
    gate_vals = gate_vals * keep
    slots = torch.arange(cap, device=x.device, dtype=F32)
    pos_oh = (pos[..., None] == slots).to(F32) * keep[..., None]
    combine = torch.einsum("gtke,gtkc->gtec", sel,
                           pos_oh * gate_vals[..., None])

    me = torch.mean(probs, dim=1)
    ce = torch.mean(sel.sum(dim=2), dim=1)
    lb = e * torch.mean(torch.sum(me * ce, dim=-1))
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = 0.01 * lb + 0.001 * zl

    dispatch = (combine > 0.0).to(x.dtype)
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xt)
    h_g = act_fn(torch.einsum("egcd,edf->egcf", xe,
                              p["w_gate"].to(x.dtype)), cfg.act)
    h_u = torch.einsum("egcd,edf->egcf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("egcf,efd->egcd", h_g * h_u, p["w_down"].to(x.dtype))
    y = torch.einsum("egcd,gtec->gtd", ye, combine.to(x.dtype))
    y = y.reshape(B, S, d)
    if cfg.moe.shared_expert:
        y = y + TF.dense_ffn(p["shared"], x, cfg)
    return y, aux, xe
