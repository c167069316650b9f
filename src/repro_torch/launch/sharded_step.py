"""The sharded training step over ``torch.distributed`` (the mesh and
sharding lines of ``repro.launch.train`` and the ``param_shardings=`` pin
of ``repro.launch.steps.make_train_step``).

A ``ShardPlan`` is one rank's view of a model mesh (``launch.mesh``) and
of the parameter specs (``launch.sharding.param_shardings``):

* Storage.  Each parameter and both of its AdamW moments live on the rank
  as the local shard of its spec (``shard``); ``state_bytes`` is what the
  plan says a rank holds.
* Compute runs on gathered weights.  The forward gathers the top-level
  leaves (embedding, final norms, unembedding) once per microbatch and
  each pattern repeat's block parameters inside the repeat's recompute
  region, through ``models.sharding_hooks.gather``: the peak holds one
  layer's gathered weights, not the model's, and the backward's recompute
  gathers again, as FSDP does.  Splitting the compute itself over
  ``model`` (tensor-parallel matmuls) is not done here.
* Gradients.  The gather is an autograd function whose backward reduces
  the full gradient to the local shard: over a data axis (the ranks that
  computed different rows) it sums, by a reduce-scatter where the leaf is
  split over that axis and an all-reduce where it is not, and the sum is
  divided by the data ranks' count (each rank's loss is the mean over its
  own rows); over ``model`` every rank computed the same rows, so it takes
  its slice and sums nothing.
* Batch.  Each data rank takes its slice of the global batch
  (``shard_batch``, the spec of ``launch.sharding.batch_shardings``):
  dimension 1 of a train batch (microbatches, batch, ...), the whole batch
  when it does not divide.  The slices' union is the one-rank batch.
* Clipping norm.  The global norm sums each element's square once: each
  leaf's local sum of squares is all-reduced over the mesh axes its spec
  splits it over (a replicated leaf counts once), then the leaves are
  summed in ``optim.global_norm``'s order, so a (1, 1) mesh gives its bits.

Every collective goes through ``ShardPlan``'s helpers, and an axis of size
1 issues none, so a (1, 1) mesh computes exactly the one-device step.
``DryShardPlan`` is the same plan with no process group: its helpers
return empty tensors of the result's shape and tally each call
(``launch.dryrun`` traces a rank's step with it on the meta device).
gloo on the H100 machine's torch 2.11 takes CUDA tensors in
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce`` and
``barrier`` (checked there for 2 and 4 ranks sharing the card), so
nothing is staged through host copies here; NCCL runs as a 1-rank group on
the one card.

MoE archs: the router's auxiliary loss and the expert capacity are
computed per data rank on its own rows, so on a mesh with more than one
data rank an MoE step differs from the one-rank step by more than
rounding; over ``model`` alone it does not.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import dict_leaves, map_dict, tree_leaves
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import axis_sizes, data_axes
from repro_torch.models import model as M
from repro_torch.models import sharding_hooks

_F32 = torch.float32


def _spec_axis_set(spec) -> set:
    return {a for e in spec for a in SH.spec_axes(e)}


class _Gather(torch.autograd.Function):
    """Local shard -> full tensor; backward: full gradient -> the local
    shard of its data-rank mean."""

    @staticmethod
    def forward(ctx, x, plan, spec):
        ctx.plan, ctx.spec = plan, spec
        return plan._gather(x, spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan._reduce_grad(g, ctx.spec), None, None


class ShardPlan:
    """One rank's view of ``mesh`` (a ``DeviceMesh``; a ``MeshShape`` with
    ``coord`` for plans without collectives) and of ``cfg``'s parameter
    specs for ``kind`` ("train", "prefill" or "decode":
    ``launch.sharding.param_shardings``' kind)."""

    def __init__(self, cfg: ArchConfig, mesh,
                 coord: Optional[Sequence[int]] = None, kind: str = "train"):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.dp = data_axes(mesh)
        self.dp_size = math.prod(self.sizes[a] for a in self.dp)
        self.specs = SH.param_shardings(cfg, mesh, M.logical_axes(cfg),
                                        M.abstract_params(cfg), kind)
        if coord is None:
            coord = mesh.get_coordinate()
        self.coord: Dict[str, int] = dict(zip(self.sizes, coord))
        self.rank = 0
        for a, n in self.sizes.items():
            self.rank = self.rank * n + self.coord[a]
        self.world = math.prod(self.sizes.values())
        blocks = {"blocks": self.specs["blocks"]}
        if "encoder" in self.specs:
            blocks["encoder/blocks"] = self.specs["encoder"]["blocks"]
        # one repeat's specs: the stacked layers axis is never split
        self._repeat_specs = {site: map_dict(self._drop_layers, sp)
                              for site, sp in blocks.items()}

    @staticmethod
    def _drop_layers(spec):
        assert spec[0] is None, spec
        return spec[1:]

    # ------------------------------------------------------------ storage
    def shard(self, params: Any) -> Any:
        """This rank's shards of a full parameter tree."""
        def take(x, spec):
            y = x[SH.shard_region(tuple(x.shape), spec, self.mesh,
                                  self.coord)]
            return y if y.shape == x.shape else y.clone()

        return map_dict(take, params, self.specs)

    def state_bytes(self) -> Dict[str, int]:
        """Bytes of this rank's parameter shards and of its two AdamW
        moments, from the plan alone."""
        from repro_torch.models.common import DTYPES

        opt = DTYPES[self.cfg.opt_state_dtype].itemsize
        p = m = 0
        for x, spec in zip(dict_leaves(M.abstract_params(self.cfg)),
                           dict_leaves(self.specs)):
            n = math.prod(SH.local_shape(tuple(x.shape), spec, self.mesh))
            p += n * x.element_size()
            m += 2 * n * opt
        return {"params": p, "moments": m}

    def shard_batch(self, shape: ShapeConfig, batch: Dict[str, Any]
                    ) -> Dict[str, Any]:
        """This data rank's rows of a global batch (numpy or tensors)."""
        specs = SH.batch_shardings(self.mesh, shape, batch)
        return {k: x[SH.shard_region(tuple(x.shape), specs[k], self.mesh,
                                     self.coord)]
                for k, x in batch.items()}

    # -------------------------------------------------------- collectives
    def _group(self, axis: str):
        return self.mesh.get_group(axis)

    def _collective(self, op: str, result: torch.Tensor, issue) -> None:
        """Issue one collective (``issue()``) whose result is ``result``;
        ``op`` is its kind ("all-gather", "reduce-scatter",
        "all-reduce")."""
        issue()

    # gloo takes the concatenated form only: (n x0, x1, ...)
    def _all_gather(self, x, dim: int, axis: str):
        n = self.sizes[axis]
        buf = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._collective("all-gather", buf,
                         lambda: dist.all_gather_into_tensor(
                             buf, x.contiguous(), group=self._group(axis)))
        return buf.unflatten(0, (n, x.shape[0])).movedim(0, dim).flatten(
            dim, dim + 1)

    def _reduce_scatter(self, g, dim: int, axis: str):
        n = self.sizes[axis]
        inp = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
        out = torch.empty(inp.shape[1:], dtype=g.dtype, device=g.device)
        self._collective("reduce-scatter", out,
                         lambda: dist.reduce_scatter_tensor(
                             out, inp.contiguous().flatten(0, 1),
                             group=self._group(axis)))
        return out

    def _narrow(self, g, dim: int, axis: str):
        c = g.shape[dim] // self.sizes[axis]
        return g.narrow(dim, self.coord[axis] * c, c)

    def _all_reduce(self, t, axis: str, op=None):
        t = t.clone(memory_format=torch.contiguous_format)
        kw = {} if op is None else {"op": op}
        self._collective("all-reduce", t, lambda: dist.all_reduce(
            t, group=self._group(axis), **kw))
        return t

    def _gather(self, x, spec):
        out = x
        for dim, entry in enumerate(spec):
            for a in reversed(SH.spec_axes(entry)):
                if self.sizes[a] > 1:
                    out = self._all_gather(out, dim, a)
        return x.view_as(x) if out is x else out

    def _reduce_grad(self, g, spec):
        # model slices first (no traffic; the data reductions then move
        # only the local columns), then the data reductions; within a
        # dimension split over several axes, major first
        def split(g, dim, axes):
            for a in axes:
                if self.sizes[a] > 1:
                    g = (self._reduce_scatter(g, dim, a) if a in self.dp
                         else self._narrow(g, dim, a))
            return g

        with_data = []
        for dim, entry in enumerate(spec):
            axes = SH.spec_axes(entry)
            if any(a in self.dp for a in axes):
                with_data.append((dim, axes))
            else:
                g = split(g, dim, axes)
        for dim, axes in with_data:
            g = split(g, dim, axes)
        used = _spec_axis_set(spec)
        for a in self.dp:
            if self.sizes[a] > 1 and a not in used:
                g = self._all_reduce(g, a)
        return g / self.dp_size if self.dp_size > 1 else g

    def gather(self, x, spec):
        """The full tensor of local shard ``x`` (differentiable)."""
        return _Gather.apply(x, self, spec)

    def gather_tree(self, tree: Any, specs: Any) -> Any:
        return map_dict(self.gather, tree, specs)

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks of a per-rank value."""
        if self.dp_size == 1:
            return t
        for a in self.dp:
            if self.sizes[a] > 1:
                t = self._all_reduce(t, a)
        return t / self.dp_size

    def global_norm(self, grads: Any) -> torch.Tensor:
        """``optim.global_norm`` of the full gradient, from its shards."""
        sq = [torch.sum(torch.square(g.to(_F32))) for g in tree_leaves(grads)]
        by_axes: Dict[tuple, list] = {}
        for i, spec in enumerate(dict_leaves(self.specs)):
            used = _spec_axis_set(spec)
            axes = tuple(a for a in self.sizes
                         if a in used and self.sizes[a] > 1)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            t = torch.stack([sq[i] for i in idx])
            for a in axes:
                t = self._all_reduce(t, a)
            for j, i in enumerate(idx):
                sq[i] = t[j]
        total = None
        for s in sq:
            total = s if total is None else total + s
        return torch.sqrt(total)

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` is set on any rank of the mesh."""
        t = torch.tensor([int(flag)], device=device)
        for a, n in self.sizes.items():
            if n > 1:
                t = self._all_reduce(t, a, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    # ------------------------------------------------------------ forward
    def forward_view(self, params: Any) -> Any:
        """The parameter tree ``forward_train`` reads: the top-level leaves
        gathered, the stacked blocks local (their repeats are gathered by
        the hook ``hooks`` installs)."""
        out = {}
        for k, v in params.items():
            if k == "blocks":
                out[k] = v
            elif k == "encoder":
                out[k] = {"blocks": v["blocks"],
                          "final_norm": self.gather(
                              v["final_norm"],
                              self.specs["encoder"]["final_norm"])}
            else:
                out[k] = self.gather(v, self.specs[k])
        return out

    @contextlib.contextmanager
    def hooks(self, shape: ShapeConfig, cache_specs: Any = None):
        """The gather hook and ``shape``'s activation policy installed for
        the block, both removed after it.  With ``cache_specs`` (the spec
        tree of ``launch.sharding.cache_shardings``) the hook also gathers
        each repeat's decode cache (site "cache") over every axis that
        splits it but the batch dimension's data axes: a rank decodes its
        own rows."""
        SH.activation_policy(self.mesh, self.cfg, shape)
        cache = (None if cache_specs is None else
                 map_cache_specs(lambda sp: sp[1:],
                                 rows_specs(cache_specs, self.dp)))

        def gather(tree, site):
            if site == "cache":
                return map_specs(self._gather, tree, cache)
            return self.gather_tree(tree, self._repeat_specs[site])

        sharding_hooks.set_gather(gather)
        try:
            yield
        finally:
            sharding_hooks.set_policy(None)
            sharding_hooks.set_gather(None)


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree``, whose dicts may hold a subset of
    ``specs``' keys and whose tuples hold leaves."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, sp) for v, sp in zip(tree, specs))
    return fn(tree, specs)


def map_cache_specs(fn, specs: Any) -> Any:
    """``fn`` over the tensor specs of a cache spec tree (dicts, and
    tuples of a cross K / V pair; a tensor's spec starts with its layers
    dimension's None, a scalar's is ())."""
    if isinstance(specs, dict):
        return {k: map_cache_specs(fn, v) for k, v in specs.items()}
    if specs and isinstance(specs[0], tuple):
        return type(specs)(map_cache_specs(fn, v) for v in specs)
    return fn(specs)


def rows_specs(specs: Any, dp: Tuple[str, ...]) -> Any:
    """Cache specs with each tensor's batch dimension (1) whole where the
    data axes split it: the specs of a data rank's own rows, which it
    computes (prefill) and decodes itself."""
    def keep_rows(spec):
        if len(spec) < 2 or not set(SH.spec_axes(spec[1])) & set(dp):
            return spec
        return (spec[0], None) + tuple(spec[2:])

    return map_cache_specs(keep_rows, specs)


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


class DryShardPlan(ShardPlan):
    """A ``ShardPlan`` at mesh coordinate ``coord`` (rank 0's by default)
    that needs no process group: each collective helper returns an empty
    tensor of its result's shape on the operand's device (meta in a dry
    run) and adds one call and the result's bytes to ``tally`` under the
    reference dry run's five keys (``repro.launch.dryrun``'s
    ``collective_bytes`` counts the result shapes of the HLO's collectives
    the same way).  "all-to-all" and "collective-permute" stay 0: the
    plan issues neither."""

    def __init__(self, cfg: ArchConfig, mesh,
                 coord: Optional[Sequence[int]] = None, kind: str = "train"):
        if coord is None:
            coord = (0,) * len(axis_sizes(mesh))
        super().__init__(cfg, mesh, coord, kind)
        self.tally = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}

    def _collective(self, op: str, result: torch.Tensor, issue) -> None:
        t = self.tally[op]
        t["count"] += 1
        t["bytes"] += result.numel() * result.element_size()


def elastic_remesh(n_available: int, old_mesh, shape: ShapeConfig):
    """The (data, model) ``MeshShape`` and the train shape to resume a run
    checkpointed on ``old_mesh`` with ``n_available`` ranks, through
    ``runtime.elastic.plan_elastic_remesh``: the model axis kept, the data
    axis halved until it fits, the microbatches multiplied by the plan's
    ``microbatch_scale`` so the global batch is unchanged.  None if not
    even one data rank fits."""
    import dataclasses

    from repro_torch.launch.mesh import MeshShape
    from repro_torch.runtime.elastic import plan_elastic_remesh

    sizes = axis_sizes(old_mesh)
    plan = plan_elastic_remesh(n_available, model_axis=sizes["model"],
                               old_data_axis=sizes["data"],
                               pods=sizes.get("pod", 1))
    if plan is None:
        return None
    return (MeshShape(plan.axis_names, plan.mesh_shape),
            dataclasses.replace(
                shape, microbatches=shape.microbatches * plan.microbatch_scale))
