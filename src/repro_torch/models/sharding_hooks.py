"""Pluggable activation-sharding hooks (port of
``repro.models.sharding_hooks``).

The models call ``constrain(x, kind)`` at the reference's sites (the
residual stream ``act_btd`` at layer boundaries, ``logits``, and in the
decode attention ``cache_kv`` and ``decode_scores``).  With no policy
installed it returns ``x`` itself, so a single-device forward is
unchanged.  The launcher installs a policy (``launch.sharding.
activation_policy``) that maps ``kind`` to what the mesh needs.

``gather(tree, site)`` is the port's own second hook, with no reference
counterpart: the full-sequence forward passes each repeat's block
parameters through it (``site`` "blocks" or "encoder/blocks") inside the
repeat's recompute region.  The sharded training step
(``launch.sharded_step``) installs a gather that turns the local shards
into full tensors there, which is what GSPMD's per-layer all-gathers do
in the reference; with none installed it returns ``tree`` itself.
Keeping the hooks here spares the models a dependency on ``launch``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

_POLICY: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None
_GATHER: Optional[Callable[[Any, str], Any]] = None


def set_policy(fn: Optional[Callable[[torch.Tensor, str], torch.Tensor]]
               ) -> None:
    global _POLICY
    _POLICY = fn


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    if _POLICY is None:
        return x
    return _POLICY(x, kind)


def set_gather(fn: Optional[Callable[[Any, str], Any]]) -> None:
    global _GATHER
    _GATHER = fn


def gather(tree: Any, site: str) -> Any:
    if _GATHER is None:
        return tree
    return _GATHER(tree, site)
