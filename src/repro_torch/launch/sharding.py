"""Sharding rules of the port: logical parameter / activation axes -> mesh
axes, and the campaign's cells plan (port of ``repro.launch.sharding``).

A MaxText-style rules table with divisibility-aware resolution: a logical
axis maps to its mesh axes only when the dimension divides evenly by their
sizes' product, and a mesh axis serves one dimension of a tensor at most,
so every arch resolves on every mesh (seamless's vocabulary of 256,206
stays replicated over ``model``).

Two parameter policies, as the reference's:
  tp    — weights sharded over ``model`` only (small archs);
  fsdp  — weights also sharded over the data axes on the embed axis
          (``FSDP_ARCHS``, matched by prefix, so their smoke configs too).
Optimizer moments shard exactly like their parameter.

A spec is a plain tuple, one entry per dimension: ``None`` (replicated),
a mesh axis name, or a tuple of names (the dimension split over their
product, the first axis major) — ``tuple(PartitionSpec(...))`` of the
reference's spec, entry for entry.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or a ``MeshShape`` (names
and sizes only, for meshes this host cannot build, such as (16, 16)).
``placements`` turns a spec into DTensor placements.

The activation policy checks the batch dimension of what it is given
against the mesh's local batch and is otherwise the identity: the port's
sharded step (``launch.sharded_step``) computes on gathered weights, and
its activations are each rank's own (see that module).

The environment knobs are the reference's: ``REPRO_ATTN_DP_ARCHS`` (archs
whose attention projections are replicated), ``REPRO_FULL_DP_ARCHS``
(archs with every weight replicated) and ``REPRO_SERVE_WEIGHT_AXES=tp``
(serving weights over ``model`` only).
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes, data_axes

FSDP_ARCHS = (
    "internlm2-20b",
    "qwen3-8b",
    "llama4-maverick-400b-a17b",
    "jamba-1.5-large-398b",
)

Spec = Tuple[Any, ...]


def _env_archs(name: str) -> Tuple[str, ...]:
    return tuple(x for x in os.environ.get(name, "").split(",") if x)


def plan_cell_tiles(tiles: int, n_dev: int) -> Tuple[int, int]:
    """Even tiles-per-device plan for the campaign's 1-D cells axis.

    Returns ``(tiles_per_dev, padded_tiles)``, ``padded_tiles`` the
    smallest multiple of ``n_dev`` >= ``tiles``.  The campaign engine pads
    a launch with budget-0 lanes up to ``padded_tiles`` instead of running
    it on fewer devices (``campaign.engine._device_plan``); the pad costs at
    most ``n_dev - 1`` frozen tiles, which leave on their first early-exit
    chunk.
    """
    assert tiles > 0 and n_dev > 0, (tiles, n_dev)
    per = -(-tiles // n_dev)
    return per, per * n_dev


def param_rules(cfg: ArchConfig, mesh, kind: str = "train"
                ) -> Dict[str, Tuple[str, ...]]:
    """Logical axis -> mesh axes for ``cfg``'s parameters."""
    dp = data_axes(mesh)
    fsdp = cfg.name in FSDP_ARCHS or cfg.name.startswith(FSDP_ARCHS)
    if kind != "train" and os.environ.get("REPRO_SERVE_WEIGHT_AXES") == "tp":
        fsdp = False
    emb = dp if fsdp else ()
    attn_spec = () if cfg.name in _env_archs("REPRO_ATTN_DP_ARCHS") else (
        "model",)
    if cfg.name in _env_archs("REPRO_FULL_DP_ARCHS"):
        return {k: () for k in ("vocab", "embed", "q_proj", "kv_proj",
                                "heads", "ffn", "experts", "expert_ffn",
                                "layers", "conv")}
    return {
        "vocab": ("model",),
        "embed": emb,
        "q_proj": attn_spec,
        "kv_proj": attn_spec,
        "heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "expert_ffn": dp,
        "layers": (),
        "conv": (),
    }


def spec_entry(axes: Tuple[str, ...]):
    """One spec entry of the mesh axes ``axes``: None, a name or a tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_pspec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                  rules: Dict[str, Tuple[str, ...]], mesh) -> Spec:
    """Map logical axes to mesh axes, dropping any that do not divide the
    dimension evenly or that another dimension of the tensor already
    uses."""
    used: set = set()
    out = []
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, axes):
        spec: Tuple[str, ...] = ()
        if ax is not None:
            cand = tuple(a for a in rules.get(ax, ()) if a not in used)
            total = math.prod(sizes[a] for a in cand)
            if cand and dim % total == 0:
                spec = cand
                used.update(cand)
        out.append(spec_entry(spec))
    return tuple(out)


def _map_params(fn, axes: Any, shapes: Any) -> Any:
    """``fn(axes_leaf, shape_leaf)`` over a nested-dict parameter tree
    whose axes leaves are tuples."""
    if isinstance(axes, dict):
        return {k: _map_params(fn, axes[k], shapes[k]) for k in axes}
    return fn(axes, shapes)


def param_shardings(cfg: ArchConfig, mesh, specs_axes: Any,
                    specs_shapes: Any, kind: str = "train") -> Any:
    """The spec tree of the parameter tree (and of its moments):
    ``specs_axes`` from ``models.model.logical_axes``, ``specs_shapes``
    any tree of the same structure whose leaves have a ``shape``
    (``models.model.abstract_params``)."""
    rules = param_rules(cfg, mesh, kind)
    return _map_params(
        lambda ax, x: resolve_pspec(tuple(x.shape), ax, rules, mesh),
        specs_axes, specs_shapes)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension, in
    the mesh's order, ``Shard(dim)`` for the tensor dimension it splits or
    ``Replicate()``.  A tensor dimension split over several mesh axes
    lists them major first; ``Shard`` orders such splits by mesh
    dimension, so a spec whose axes run against the mesh's order has no
    placements and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} runs against the mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def first_replica(spec: Spec, coord: Dict[str, int]) -> bool:
    """Whether the rank at ``coord`` holds the first replica of its shard
    under ``spec``: index 0 on every mesh axis the spec does not use."""
    used = {a for e in spec for a in spec_axes(e)}
    return all(i == 0 for a, i in coord.items() if a not in used)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in spec_axes(e))
                 for n, e in zip(shape, spec))


def shard_region(shape: Tuple[int, ...], spec: Spec, mesh,
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` ({axis: index}) holds under ``spec``: a dimension split over
    axes (a1, ..., ak) is cut into the product of their sizes, the rank
    taking chunk (..((i1 n2 + i2) n3 + i3)..), the first axis major."""
    sizes = axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, spec):
        axes = spec_axes(entry)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        c = n // math.prod(sizes[a] for a in axes)
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------
def local_batch(mesh, batch: int) -> int:
    """Rows of a ``batch``-row tensor that one data rank holds: the batch
    split over the data axes, or all of it when it does not divide."""
    sizes = axis_sizes(mesh)
    dp_total = math.prod(sizes[a] for a in data_axes(mesh))
    return batch // dp_total if batch % dp_total == 0 else batch


def activation_policy(mesh, cfg: ArchConfig, shape: ShapeConfig):
    """Install (``models.sharding_hooks.set_policy``) and return the
    activation policy of the cell: ``act_btd`` and ``logits`` tensors
    must hold the local batch (a train microbatch's rows, or the serving
    batch, split over the data axes); anything else passes.  long_500k
    (batch 1) constrains nothing, as the reference's policy leaves its
    activations unconstrained and its seq-sharded KV cache has no
    counterpart here."""
    from repro_torch.models import sharding_hooks

    rows = shape.global_batch
    if shape.kind == "train":
        rows //= shape.microbatches
    want = local_batch(mesh, rows)
    seq_sharded = shape.name == "long_500k"

    def policy(x, kind: str):
        if kind in ("act_btd", "logits") and not seq_sharded \
                and x.shape[0] != want:
            raise ValueError(f"{kind} holds {x.shape[0]} rows; the mesh's "
                             f"local batch is {want}")
        return x

    sharding_hooks.set_policy(policy)
    return policy


def batch_shardings(mesh, shape: ShapeConfig, batch_tree: Any) -> Any:
    """Specs of the input batch: the batch dimension (1 of a train batch's
    (microbatches, batch, ...), else 0) over the data axes, replicated
    when it does not divide (long_500k's batch of 1)."""
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_total = math.prod(sizes[a] for a in dp)

    def mk(x):
        nd = len(x.shape)
        bdim = 1 if (shape.kind == "train" and nd >= 2) else 0
        spec = [None] * nd
        if x.shape[bdim] % dp_total == 0:
            spec[bdim] = spec_entry(dp)
        return tuple(spec)

    return {k: mk(v) for k, v in batch_tree.items()}


def cache_shardings(mesh, cfg: ArchConfig, shape: ShapeConfig,
                    cache: Any) -> Any:
    """Specs of the decode cache (``launch.steps.abstract_cache``).

    decode_32k: batch over the data axes, head dim (attention) / heads
    (ssm) over ``model``.  long_500k (batch 1): the KV sequence over the
    data axes.  Scalars (the cache position, ``max_seq``) are ().
    """
    dp = spec_entry(data_axes(mesh))
    model_n = axis_sizes(mesh).get("model", 1)
    long_ctx = shape.name == "long_500k"

    def over_model(n: int):
        return "model" if n % model_n == 0 else None

    def mk(key, x):
        nd = len(getattr(x, "shape", ()))
        if nd == 0:
            return ()
        if key in ("k", "v") and nd == 5:         # (layers, B, S, H, D)
            if long_ctx:
                return (None, None, dp, None, None)
            return (None, dp, None, None, over_model(x.shape[4]))
        if key == "ssm" and nd == 5:               # (layers, B, H, P, N)
            return (None, None if long_ctx else dp, over_model(x.shape[2]),
                    None, None)
        if key == "conv" and nd == 4:              # (layers, B, K-1, C)
            return (None, None if long_ctx else dp, None,
                    over_model(x.shape[3]))
        if nd == 5:                                # cross K/V
            return (None, dp, None, None, over_model(x.shape[4]))
        return (None,) * nd

    def walk(key, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(str(i), v) for i, v in enumerate(node))
        return mk(key, node)

    return walk("", cache)
