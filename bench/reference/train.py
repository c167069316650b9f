"""Plain reference of the training step: the microbatches' mean loss and
gradient (autograd through ``model.Model.train_loss``), the gradient
clipped to a global norm, the WSD learning rate and one AdamW update, all
in float32 on float32 parameters, as the configuration's ``train_4k``
block states."""
from __future__ import annotations

import torch

from reference.model import Arch, Model

F32 = torch.float32


def leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if torch.is_tensor(v):
            out[path] = v
        else:
            out.update(leaves(v, path))
    return out


def wsd_lr(step: int, sched: dict, lr: float) -> float:
    warm = lr * min(step / max(sched["warmup"], 1), 1.0)
    start = sched["total"] * (1.0 - sched["decay_frac"])
    frac = min(max((step - start) / max(sched["total"] - start, 1), 0.0), 1.0)
    return warm * (1.0 - (1.0 - sched["min_frac"]) * frac)


def grads(arch: Arch, params: dict, batch: dict, prec) -> tuple:
    """(mean loss over the microbatches, {leaf: mean gradient})."""
    flat = leaves(params)
    for p in flat.values():
        p.requires_grad_(True)
    model = Model(arch, params, prec)
    n_mb = batch["tokens"].shape[0]
    acc = {k: torch.zeros_like(p) for k, p in flat.items()}
    losses = []
    for i in range(n_mb):
        loss = model.train_loss(batch["tokens"][i], batch["labels"][i].long())
        gs = torch.autograd.grad(loss, list(flat.values()))
        for k, g in zip(flat, gs):
            acc[k] += g.to(F32)
        losses.append(float(loss.detach()))
    for p in flat.values():
        p.requires_grad_(False)
    return sum(losses) / n_mb, {k: g / n_mb for k, g in acc.items()}


def adamw(params: dict, state: dict, g: dict, step: int, train: dict):
    """One clipped AdamW update in place; returns the clipped gradient."""
    opt, sched = train["optimizer"], train["schedule"]
    flat = leaves(params)
    norm = float(torch.sqrt(sum(torch.sum(x * x) for x in g.values())))
    scale = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
    lr = wsd_lr(step, sched, opt["lr"])
    t = step + 1
    bc1, bc2 = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
    clipped = {}
    with torch.no_grad():
        for k, p in flat.items():
            gk = g[k] * scale
            clipped[k] = gk
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(opt["b1"]).add_(gk, alpha=1.0 - opt["b1"])
            v.mul_(opt["b2"]).add_(gk * gk, alpha=1.0 - opt["b2"])
            upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
            p.sub_(lr * (upd + opt["weight_decay"] * p))
    return clipped
