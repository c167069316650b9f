"""Warmup-stable-decay learning-rate schedule (port of
``repro.optim.schedule``): a pure function of the step."""
from __future__ import annotations

import torch

_F32 = torch.float32


def wsd_schedule(step, base_lr: float, warmup: int = 100, total: int = 10000,
                 decay_frac: float = 0.2, min_frac: float = 0.1
                 ) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    0-dim tensor on the step's device: linear warmup over ``warmup``
    steps, flat, then linear decay to ``min_frac`` over the last
    ``decay_frac`` of ``total``.  Every operation is a float32 tensor
    operation, as the reference's weakly typed jnp (Python doubles would
    round differently)."""
    step = torch.as_tensor(step).to(_F32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    decay_start = total * (1.0 - decay_frac)
    frac = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                       0.0, 1.0)
    decay = 1.0 - (1.0 - min_frac) * frac
    return warm * decay
