"""Step functions of the trainer and the server (port of
``repro.launch.steps``).

``make_train_step`` is the reference's unsharded train step: the loss
and its gradient (accumulated over microbatches in the optimizer-state
dtype), the WSD learning rate and one AdamW update.  Parameters are the
port's nested-dict trees of tensors; the batch holds tensors shaped
(microbatches, batch // microbatches, ...) on the parameters' device.
The reference's ``input_specs`` / ``abstract_cache`` serve its dry-run
(abstract shapes for sharded compilation), which is scale-out work.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.common import DTYPES
from repro_torch.optim import AdamWConfig, adamw_update, wsd_schedule


def text_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Token positions per sequence: the shape's length less the frontend
    positions that precede the tokens (encoder frames do not)."""
    if cfg.n_encoder_layers:
        return shape.seq_len
    return shape.seq_len - cfg.frontend_positions


def _trainable(p: torch.Tensor) -> torch.Tensor:
    return p if p.requires_grad else p.detach().requires_grad_()


def make_grad_step(cfg: ArchConfig, shape: ShapeConfig
                   ) -> Callable[[Any, Dict[str, torch.Tensor]],
                                 Tuple[torch.Tensor, Any]]:
    """(params, batch) -> (loss, grads): ``forward_train``'s loss and its
    gradient tree.  With more than one microbatch, the gradients are
    accumulated in ``cfg.opt_state_dtype`` and divided by their count, and
    the loss is the microbatches' mean."""
    n_micro = shape.microbatches
    acc_dt = DTYPES[cfg.opt_state_dtype]

    def grads_of(params, leaves, batch, i):
        loss, _ = M.forward_train(params, cfg,
                                  {k: v[i] for k, v in batch.items()})
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, gs)]

    def grad_step(params, batch):
        params = tree_map(_trainable, params)
        leaves = tree_leaves(params)
        if n_micro == 1:
            loss, grads = grads_of(params, leaves, batch, 0)
            return loss, tree_unflatten(params, grads)
        acc, losses = None, []
        for i in range(n_micro):
            loss, grads = grads_of(params, leaves, batch, i)
            losses.append(loss)
            if acc is None:                 # 0 + g, as the reference's scan
                acc = [g.to(acc_dt) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dt))
        return (torch.mean(torch.stack(losses)),
                tree_unflatten(params, [a / n_micro for a in acc]))

    return grad_step


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10000):
    """(params, m, v, step, batch) -> (params, m, v, step + 1, metrics)
    with metrics {"loss", "grad_norm", "lr"} (0-dim tensors); the learning
    rate is ``wsd_schedule(step, opt.lr, total=total_steps)``."""
    grad_step = make_grad_step(cfg, shape)

    def train_step(params, m, v, step, batch):
        loss, grads = grad_step(params, batch)
        lr = wsd_schedule(step, opt.lr, total=total_steps)
        params, m, v, gn = adamw_update(params, grads, m, v, step, opt, lr)
        return params, m, v, step + 1, {"loss": loss, "grad_norm": gn,
                                        "lr": lr}

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig):
    def prefill(params, batch):
        return M.serve_prefill(params, cfg, batch, max_seq=shape.seq_len)

    return prefill


def make_decode_step(cfg: ArchConfig, shape: ShapeConfig):
    def decode(params, cache, tokens):
        return M.serve_step(params, cfg, cache, tokens)

    return decode
