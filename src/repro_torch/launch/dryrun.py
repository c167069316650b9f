"""Multi-pod dry run of the port: trace one rank's step of every (arch x
shape x mesh) cell on the meta device (port of ``repro.launch.dryrun``).

For each cell this records, to
``results/dryrun_torch/<arch>__<shape>__<mesh>.json``, in the
reference's schema:

  * ``memory``: ``argument_size_in_bytes`` — the rank's parameter shards
    and batch rows, with its AdamW moments and step counter (train) or
    its decode cache shards and position (decode), from the plan (the
    counter and the position, host ints here, count as the reference's
    int32 scalars); ``output_size_in_bytes`` — what the step returns;
    ``alias_size_in_bytes`` — what donation lets the outputs reuse (the
    parameters and moments of a train step, the cache of a decode step);
    ``temp_size_in_bytes`` — ``launch.live_bytes``' peak of the live
    bytes beyond the arguments; ``generated_code_size_in_bytes`` — None,
    since an eager step generates no code;
  * ``cost``: ``flops`` — the rank's traced matmul FLOPs (the counter of
    ``launch.flops_audit``), ``bytes accessed`` — the bytes its ops
    read and write, with no fusion (``launch.live_bytes``);
  * ``collectives``: the dry plan's tally (``collective_bytes``);
  * ``flops_audit_global`` / ``flops_audit_per_device``, as the
    reference's, and ``flops_rank``.  The port's rank computes on gathered
    weights (``launch.sharded_step``, ROADMAP B11): ranks along ``model``
    repeat each other's work, so what one rank computes (``flops_rank``,
    the FLOPs the roofline's compute term reads) is the global count over
    the data ranks, not over all devices.  ``flops_audit_global`` is
    ``flops_rank`` times the data ranks that split the batch (1 where the
    batch is replicated) and ``flops_audit_per_device`` that over the
    devices: the split a tensor-parallel step would reach, kept for the
    reference's roofline;
  * ``t_lower_s``: the wall time of building and tracing the cell;
    ``t_compile_s``: 0, since nothing is compiled.

A cell is traced at mesh coordinate 0 with ``launch.sharded_step.
DryShardPlan``, which issues no collective and needs no process group,
so a (16, 16) or (2, 16, 16) mesh is sized on one CPU.  The reference
sets ``XLA_FLAGS`` to 512 host devices before it imports JAX; the dry
plan needs no devices, so nothing here corresponds to it.

Single-pod mesh = (data 16, model 16) = 256 ranks; multi-pod = (pod 2,
16, 16) = 512.  The run is resumable: existing JSONs are skipped unless
``--force``.  ``launch.roofline`` reads them.

  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import map_dict, tree_leaves
from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, ArchConfig,
                                      ShapeConfig, shape_for)
from repro_torch.configs.registry import ARCHS, TRAIN_MICROBATCHES, get_arch
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.live_bytes import LiveBytes
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.launch.sharded_step import (DryShardPlan, map_specs,
                                             rows_specs)
from repro_torch.models import model as M
from repro_torch.models.common import DTYPES

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# an int32 scalar of the reference's step arguments and outputs (the train
# step counter, the decode cache's position), a host int in the port's:
# counted as the reference counts it
SCALAR_BYTES = 4


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell, ready to trace: ``step_fn(*args)`` on
    meta tensors; the rank's argument and alias bytes, and the bytes of
    the reference's int32 scalars among its outputs."""
    cfg: ArchConfig
    shape: ShapeConfig
    mesh: MeshShape
    plan: DryShardPlan
    step_fn: Callable
    args: tuple
    argument_bytes: int
    alias_bytes: int
    scalar_outputs: int = 0


def nbytes(tree: Any) -> int:
    """Bytes of the tensors of ``tree``."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _take(tree: Any, specs: Any, mesh, coord: Dict[str, int]) -> Any:
    """The rank's shard of each tensor of ``tree`` under ``specs`` (a
    copy where the shard is a part)."""
    def take(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        y = x[SH.shard_region(tuple(x.shape), spec, mesh, coord)]
        return y if y.shape == x.shape else y.clone()

    return map_specs(take, tree, specs)


def build(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshShape,
          coord: Optional[Sequence[int]] = None) -> Cell:
    """Rank ``coord``'s (default 0's) step of ``cfg`` at ``shape`` on
    ``mesh``, its arguments on the meta device."""
    plan = DryShardPlan(cfg, mesh, coord, kind=shape.kind)
    params = plan.shard(M.abstract_params(cfg))
    batch = plan.shard_batch(shape, ST.input_specs(cfg, shape))
    if shape.kind == "train":
        step = ST.make_train_step(cfg, shape, plan=plan)
        opt = DTYPES[cfg.opt_state_dtype]
        args = (params, map_dict(lambda p: torch.empty_like(p, dtype=opt),
                                 params),
                map_dict(lambda p: torch.empty_like(p, dtype=opt), params), 0,
                batch)
        state = nbytes(args[:3])
        return Cell(cfg, shape, mesh, plan, step, args,
                    state + nbytes(batch) + SCALAR_BYTES, state,
                    SCALAR_BYTES)

    cache = ST.abstract_cache(cfg, shape)
    specs = SH.cache_shardings(mesh, cfg, shape, cache)
    if shape.kind == "prefill":
        # the cache it computed holds the rank's rows: it keeps their shard
        row_specs = rows_specs(specs, plan.dp)

        def prefill(params, batch):
            with torch.no_grad(), plan.hooks(shape):
                logits, c = M.serve_prefill(plan.forward_view(params), cfg,
                                            batch, max_seq=shape.seq_len)
            return logits, _take(c, row_specs, mesh, plan.coord)

        return Cell(cfg, shape, mesh, plan, prefill, (params, batch),
                    nbytes((params, batch)), 0)

    local = _take(cache, specs, mesh, plan.coord)

    def decode(params, cache, tokens):
        with torch.no_grad(), plan.hooks(shape, cache_specs=specs):
            return M.serve_step(plan.forward_view(params), cfg, cache,
                                tokens)

    return Cell(cfg, shape, mesh, plan, decode,
                (params, local, batch["tokens"]),
                nbytes((params, local, batch["tokens"])) + SCALAR_BYTES,
                nbytes(local) + SCALAR_BYTES, SCALAR_BYTES)


def mesh_name(mesh: MeshShape) -> str:
    if tuple(mesh.shape) == (16, 16):
        return "pod_16x16"
    if tuple(mesh.shape) == (2, 16, 16):
        return "multipod_2x16x16"
    return "x".join(str(n) for n in mesh.shape)


def build_cell(arch_name: str, shape_name: str, multi_pod: bool) -> Cell:
    """The reference's cell: ``TRAIN_MICROBATCHES`` (or
    ``REPRO_TRAIN_MICROBATCHES``) for ``train_4k``, the production mesh,
    rank 0."""
    cfg = get_arch(arch_name)
    mb = TRAIN_MICROBATCHES[arch_name] if shape_name == "train_4k" else None
    if os.environ.get("REPRO_TRAIN_MICROBATCHES") and shape_name == "train_4k":
        mb = int(os.environ["REPRO_TRAIN_MICROBATCHES"])
    shape = shape_for(cfg, shape_name, microbatches=mb)
    return build(cfg, shape, production_mesh_shape(multi_pod=multi_pod))


def collective_bytes(plan: DryShardPlan) -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes"}} of the collectives ``plan`` issued: the
    counterpart of the reference's HLO parse, the result bytes of each
    call (every loop iteration counted, as torch runs each)."""
    return {k: dict(v) for k, v in plan.tally.items()}


def trace(cell: Cell, t_build: float = 0.0) -> Dict[str, Any]:
    """Trace ``cell``'s step once under the FLOP counter, the live-bytes
    tracker and the plan's tally; the reference's record of the cell."""
    t0 = time.perf_counter()
    # the counter outside the tracker: it runs the ops it has no FLOP
    # formula for (silu's backward) as their decompositions, whose parts
    # the real step never allocates, so the tracker sees the ops only
    with FlopCounterMode(display=False) as counter, \
            LiveBytes(cell.args) as tracker:
        out = cell.step_fn(*cell.args)
    flops = float(counter.get_total_flops())
    t_trace = time.perf_counter() - t0
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    rows = shape.global_batch // (shape.microbatches
                                  if shape.kind == "train" else 1)
    data_split = rows // SH.local_batch(mesh, rows)
    n_dev = math.prod(mesh.shape)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name(mesh),
        "n_devices": n_dev,
        "kind": shape.kind,
        "microbatches": shape.microbatches,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "flops_audit_global": flops * data_split,
        "flops_audit_per_device": flops * data_split / n_dev,
        "flops_rank": flops,
        "memory": {
            "argument_size_in_bytes": cell.argument_bytes,
            "output_size_in_bytes": nbytes(out) + cell.scalar_outputs,
            "temp_size_in_bytes": tracker.peak,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": cell.alias_bytes,
        },
        "cost": {"flops": flops, "bytes accessed": float(tracker.moved)},
        "collectives": collective_bytes(cell.plan),
        "t_lower_s": t_build + t_trace,
        "t_compile_s": 0.0,
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> Dict[str, Any]:
    t0 = time.perf_counter()
    cell = build_cell(arch_name, shape_name, multi_pod)
    res = trace(cell, time.perf_counter() - t0)
    if verbose:
        print(f"  memory: {res['memory']}")
        print(f"  cost: flops={res['cost']['flops']:.3e} "
              f"bytes={res['cost']['bytes accessed']:.3e}")
    return res


def cells(multi_pod: bool):
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue  # sanctioned skip: pure full-attention archs
            yield a, s, multi_pod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS.mkdir(parents=True, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        todo = [c for mp in meshes for c in cells(mp)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    failures = []
    t_all = time.perf_counter()
    for arch, shp, mp in todo:
        tag = f"{arch}__{shp}__{'multipod' if mp else 'pod'}"
        out = RESULTS / f"{tag}.json"
        if out.exists() and not args.force:
            print(f"[skip] {tag}")
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            res = run_cell(arch, shp, mp)
            out.write_text(json.dumps(res, indent=1))
            print(f"[ ok ] {tag}  lower={res['t_lower_s']:.1f}s "
                  f"compile={res['t_compile_s']:.1f}s", flush=True)
        except Exception as e:  # one cell's failure must not stop the sweep
            failures.append((tag, repr(e)))
            (RESULTS / f"{tag}.FAILED").write_text(traceback.format_exc())
            print(f"[FAIL] {tag}: {e}", flush=True)

    print(f"\ndone in {time.perf_counter() - t_all:.1f} s; "
          f"{len(failures)} failures")
    for tag, e in failures:
        print(f"  {tag}: {e[:200]}")
    return len(failures)


if __name__ == "__main__":
    main()
