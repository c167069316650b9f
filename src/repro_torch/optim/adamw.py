"""AdamW with global-norm clipping on nested-dict parameter trees (port of
``repro.optim.adamw``).

Functional, as the reference: ``adamw_update`` returns new parameter and
moment trees and leaves its inputs untouched.  Moments are kept in the
config's ``opt_state_dtype`` (bfloat16 for the big-MoE archs so parameters
and state fit the device memory, DESIGN.md §4); the update math always
runs in float32.  Scalars follow the reference's weakly typed jnp: the
bias corrections ``b1**t`` and ``b2**t`` are float32 powers of a float32
step, and the gradient norm sums the leaves in ``jax.tree_util`` order
(sorted dict keys).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.common import DTYPES

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Any, dtype: str = "float32") -> Tuple[Any, Any]:
    """Zero first and second moments shaped like ``params``, in ``dtype``,
    on each parameter's device."""
    dt = DTYPES[dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order, one after the other)
    of each leaf's float32 sum of squares."""
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(torch.square(leaf.to(_F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(params: Any, grads: Any, m: Any, v: Any, step,
                 cfg: AdamWConfig, lr=None, grad_norm=None):
    """One AdamW step at optimizer step ``step`` (0-based: the bias
    corrections use t = step + 1) with gradients clipped to a global norm
    of ``cfg.clip_norm``.  Returns (params, m, v, grad_norm); the new
    parameters keep their dtype and ``requires_grad``, the moments their
    dtype.  ``grad_norm`` (a 0-dim float32 tensor) replaces
    ``global_norm(grads)`` where ``grads`` are shards of the gradient
    (``launch.sharded_step`` computes the norm over the mesh)."""
    lr = cfg.lr if lr is None else lr
    with torch.no_grad():
        gn = global_norm(grads) if grad_norm is None else grad_norm
        dev = gn.device
        clip = torch.full_like(gn, cfg.clip_norm)
        scale = torch.clamp(clip / torch.clamp_min(gn, 1e-9), max=1.0)
        t = torch.as_tensor(step, device=dev).to(_F32) + 1.0
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=_F32, device=dev), t)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=_F32, device=dev), t)
        lr = torch.as_tensor(lr, dtype=_F32, device=dev)

        new_p, new_m, new_v = [], [], []
        for p, g, m_, v_ in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(m), tree_leaves(v)):
            g = g.to(_F32) * scale
            m_new = cfg.b1 * m_.to(_F32) + (1.0 - cfg.b1) * g
            v_new = cfg.b2 * v_.to(_F32) + (1.0 - cfg.b2) * torch.square(g)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p.to(_F32))
            p_new = (p.to(_F32) - lr * delta).to(p.dtype)
            new_p.append(p_new.requires_grad_(p.requires_grad))
            new_m.append(m_new.to(m_.dtype))
            new_v.append(v_new.to(v_.dtype))
    return (tree_unflatten(params, new_p), tree_unflatten(m, new_m),
            tree_unflatten(v, new_v), gn)
