"""Step functions of the trainer and the server (port of
``repro.launch.steps``).

``make_train_step`` is the reference's unsharded train step: the loss
and its gradient (accumulated over microbatches in the optimizer-state
dtype), the WSD learning rate and one AdamW update.  Parameters are the
port's nested-dict trees of tensors; the batch holds tensors shaped
(microbatches, batch // microbatches, ...) on the parameters' device.
``input_specs`` / ``abstract_cache`` are the abstract inputs of a cell:
meta-device tensors (shapes and dtypes, no storage) of the batch and the
decode cache, as the reference's ``ShapeDtypeStruct`` stand-ins; the
sharding plans (``launch.sharding``) and the sharded step read them.
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


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """The abstract input batch of the (arch, shape) cell, on the meta
    device: train (microbatches, batch // microbatches, S) tokens and
    labels (int32), prefill (B, S) tokens, decode (B, 1) tokens; frontend
    embeddings or encoder frames (..., frontend_positions, d_model) in the
    compute dtype where the arch has them."""
    B = shape.global_batch
    S = text_len(cfg, shape)
    F = cfg.frontend_positions
    cdt = DTYPES[cfg.compute_dtype]

    def meta(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta((B, 1))}
    if shape.kind == "train":
        mb = shape.microbatches
        if B % mb:
            raise ValueError(f"global batch {B} does not split into {mb} "
                             "microbatches")
        lead = (mb, B // mb)
        batch = {"tokens": meta(lead + (S,)), "labels": meta(lead + (S,))}
    else:
        lead = (B,)
        batch = {"tokens": meta(lead + (S,))}
    if F:
        key = "encoder_frames" if cfg.n_encoder_layers else "frontend_embeds"
        batch[key] = meta(lead + (F, cfg.d_model), cdt)
    return batch


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``init_cache`` of the cell's batch and sequence on the meta device."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def _trainable(p: torch.Tensor) -> torch.Tensor:
    return p if p.requires_grad else p.detach().requires_grad_()


def make_grad_step(cfg: ArchConfig, shape: ShapeConfig, plan=None
                   ) -> Callable[[Any, Dict[str, torch.Tensor]],
                                 Tuple[torch.Tensor, Any]]:
    """(params, batch) -> (loss, grads): ``forward_train``'s loss and its
    gradient tree.  With more than one microbatch, the gradients are
    accumulated in ``cfg.opt_state_dtype`` and divided by their count, and
    the loss is the microbatches' mean.

    With a ``launch.sharded_step.ShardPlan`` (the reference's
    ``param_shardings=``), ``params`` are this rank's shards and ``batch``
    this data rank's rows; the forward runs on the plan's gathered view
    under its hooks, the gradients are the shards of the data ranks' mean
    gradient and the loss the data ranks' mean."""
    n_micro = shape.microbatches
    acc_dt = DTYPES[cfg.opt_state_dtype]
    view = (lambda params: params) if plan is None else plan.forward_view

    def grads_of(params, leaves, batch, i):
        loss, _ = M.forward_train(view(params), cfg,
                                  {k: v[i] for k, v in batch.items()})
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, gs)]

    def local_step(params, batch):
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

    if plan is None:
        return local_step

    def grad_step(params, batch):
        with plan.hooks(shape):
            loss, grads = local_step(params, batch)
        return plan.data_mean(loss), grads

    return grad_step


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10000, plan=None):
    """(params, m, v, step, batch) -> (params, m, v, step + 1, metrics)
    with metrics {"loss", "grad_norm", "lr"} (0-dim tensors); the learning
    rate is ``wsd_schedule(step, opt.lr, total=total_steps)``.

    With a ``launch.sharded_step.ShardPlan`` parameters and moments are
    this rank's shards and the batch this data rank's rows
    (``make_grad_step``); the gradient norm is the whole gradient's
    (``ShardPlan.global_norm``)."""
    grad_step = make_grad_step(cfg, shape, plan)

    def train_step(params, m, v, step, batch):
        loss, grads = grad_step(params, batch)
        lr = wsd_schedule(step, opt.lr, total=total_steps)
        gn = None if plan is None else plan.global_norm(grads)
        params, m, v, gn = adamw_update(params, grads, m, v, step, opt, lr,
                                        grad_norm=gn)
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
