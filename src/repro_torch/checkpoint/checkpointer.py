"""Atomic, asynchronous checkpointing of tensor trees (torch-native
counterpart of ``repro.checkpoint.checkpointer``, with its layout).

Layout: <dir>/step_<N>/
  manifest.json   — step, host count, and per leaf its path (dict keys
                    joined with ``/``, in ``jax.tree_util`` order), shape
                    and dtype
  host<k>.pt      — ``torch.save`` of {path: CPU tensor} for this host

Properties:
  * atomic publish — written to step_<N>.tmp, then renamed; readers list
    only complete checkpoints, so a failure mid-save never corrupts one;
  * async — the disk write runs on a background thread off the train loop;
    the device -> host copy is synchronous and always a copy, so a caller
    that updates its tensors in place after ``save`` returns cannot change
    what is written;
  * ``restore(step, like, device)`` rebuilds ``like``'s structure with
    leaf tensors on the device.
"""
from __future__ import annotations

import itertools
import json
import math
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch._tree import (dict_leaves, tree_leaves_with_paths,
                               tree_unflatten)
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import (first_replica, shard_region,
                                        spec_axes, spec_entry)


def _flatten_with_paths(tree: Any):
    items = tree_leaves_with_paths(tree)
    paths = ["/".join(str(k) for k in path) for path, _ in items]
    return paths, [leaf for _, leaf in items]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class Checkpointer:
    def __init__(self, directory, host_rank: int = 0, host_count: int = 1,
                 keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_rank = host_rank
        self.host_count = host_count
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        paths, leaves = _flatten_with_paths(tree)
        host = [torch.as_tensor(leaf).detach().to("cpu", copy=True)
                for leaf in leaves]

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {
                "step": step,
                "host_count": self.host_count,
                "leaves": [{"path": p, "shape": list(t.shape),
                            "dtype": _dtype_name(t)}
                           for p, t in zip(paths, host)],
            }
            torch.save(dict(zip(paths, host)),
                       tmp / f"host{self.host_rank}.pt")
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:         # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return max(s) if s else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """``like``'s structure with the leaves of checkpoint ``step``, as
        stored (shape and dtype), on ``device`` (None: each ``like``
        leaf's device, the CPU for non-tensor leaves)."""
        d = self.dir / f"step_{step}"
        payload = torch.load(d / f"host{self.host_rank}.pt",
                             map_location="cpu", weights_only=True)
        paths, leaves = _flatten_with_paths(like)
        out = []
        for p, ref in zip(paths, leaves):
            if p not in payload:
                raise KeyError(f"checkpoint step {step} has no leaf {p!r}")
            dev = (device if device is not None else
                   ref.device if torch.is_tensor(ref) else "cpu")
            out.append(payload[p].to(dev))
        return tree_unflatten(like, out)


class ShardedCheckpointer(Checkpointer):
    """Checkpoints of a sharded state, one payload per rank, resharded on
    restore (the reference's per-host shard files and ``restore(...,
    shardings)``).

    Layout: <dir>/step_<N>/
      manifest.json  — step, the mesh (axis names and sizes), host count
                       (ranks), and per leaf its path, global shape, dtype
                       and spec (mesh axes per dimension)
      host<r>.pt     — rank r's local shards of the leaves it is the first
                       replica of (index 0 on every mesh axis the leaf's
                       spec does not split it over), so each element is
                       written once

    ``plan`` is the rank's ``launch.sharded_step.ShardPlan`` (its mesh,
    coordinate and rank).  ``save`` is collective: every rank calls it at
    the same step.  Rank 0 clears a stale ``step_<N>.tmp`` before a
    barrier, each rank writes its payload (``host<r>.pt.part``, then
    renamed), and rank 0 publishes (manifest, then the rename to
    ``step_<N>``) only once it sees every rank's payload; ``wait`` joins
    the write and, after a save, holds every rank at a barrier until the
    checkpoint is published.  ``restore`` assembles this rank's local
    shard of each leaf under the specs it is given from the payloads that
    overlap it (memory-mapped), whatever mesh wrote them.
    """

    PUBLISH_TIMEOUT_S = 600.0

    def __init__(self, directory, plan, keep: int = 3):
        super().__init__(directory, host_rank=plan.rank,
                         host_count=plan.world, keep=keep)
        self.plan = plan
        self._pending = False

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Write this rank's shards of the training state ``tree`` (local
        tensors; specs ``self.specs_of(tree)``)."""
        self.wait()
        plan = self.plan
        paths, leaves = _flatten_with_paths(tree)
        leaves_meta, host = [], {}
        for p, x, spec in zip(paths, leaves,
                              dict_leaves(self.specs_of(tree))):
            x = torch.as_tensor(x)
            shape = [n * math.prod(plan.sizes[a] for a in spec_axes(e))
                     for n, e in zip(x.shape, spec)]
            leaves_meta.append({"path": p, "shape": shape,
                                "dtype": _dtype_name(x),
                                "spec": [list(spec_axes(e)) for e in spec]})
            if first_replica(spec, plan.coord):
                host[p] = x.detach().to("cpu", copy=True)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if plan.rank == 0 and tmp.exists():
            shutil.rmtree(tmp)
        plan.barrier()

        def _write():
            tmp.mkdir(parents=True, exist_ok=True)
            part = tmp / f"host{plan.rank}.pt.part"
            torch.save(host, part)
            part.rename(tmp / f"host{plan.rank}.pt")
            if plan.rank != 0:
                return
            names = [tmp / f"host{r}.pt" for r in range(plan.world)]
            deadline = time.monotonic() + self.PUBLISH_TIMEOUT_S
            while not all(n.exists() for n in names):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"checkpoint step {step}: not every "
                                       "rank's payload arrived")
                time.sleep(0.01)
            manifest = {"step": step, "host_count": plan.world,
                        "mesh": {"axis_names": list(plan.sizes),
                                 "shape": list(plan.sizes.values())},
                        "leaves": leaves_meta}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        self._pending = True
        if blocking:
            _write()
            self.wait()
            return

        def _run():
            try:
                _write()
            except Exception as e:         # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write (re-raising its failure); after a save,
        hold every rank until rank 0 has published it."""
        pending, self._pending = self._pending, False
        super().wait()
        if pending:
            self.plan.barrier()

    def specs_of(self, tree: Any) -> Any:
        """Specs of a training state {"params", "m", "v", "step"}: the
        moments shard like their parameters, the step is replicated."""
        out = {k: self.plan.specs for k in ("params", "m", "v") if k in tree}
        out.update({k: () for k in tree if k not in out})
        return out

    def restore(self, step: int, like: Any, device=None) -> Any:
        """``like``'s structure (a training state) with this rank's shards
        (under ``self.specs_of(like)``) of checkpoint ``step``'s leaves, on
        ``device`` (None: each ``like`` leaf's device, the CPU for
        non-tensor leaves)."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        old = MeshShape(tuple(manifest["mesh"]["axis_names"]),
                        tuple(manifest["mesh"]["shape"]))
        old_coords = [dict(zip(old.axis_names, c))
                      for c in itertools.product(*map(range, old.shape))]
        entries = {e["path"]: e for e in manifest["leaves"]}
        payloads = {}

        def payload(r):
            if r not in payloads:
                payloads[r] = torch.load(d / f"host{r}.pt", mmap=True,
                                         map_location="cpu",
                                         weights_only=True)
            return payloads[r]

        plan = self.plan
        paths, leaves = _flatten_with_paths(like)
        out = []
        for p, ref, spec in zip(paths, leaves,
                                dict_leaves(self.specs_of(like))):
            if p not in entries:
                raise KeyError(f"checkpoint step {step} has no leaf {p!r}")
            e = entries[p]
            shape = tuple(e["shape"])
            old_spec = tuple(spec_entry(a) for a in e["spec"])
            region = shard_region(shape, spec, plan.mesh, plan.coord)
            t = torch.empty(tuple(s.stop - s.start for s in region),
                            dtype=getattr(torch, e["dtype"]))
            for r, oc in enumerate(old_coords):
                if not first_replica(old_spec, oc):
                    continue
                oreg = shard_region(shape, old_spec, old, oc)
                lo = [max(a.start, b.start) for a, b in zip(region, oreg)]
                hi = [min(a.stop, b.stop) for a, b in zip(region, oreg)]
                if any(x >= y for x, y in zip(lo, hi)):
                    continue
                src = payload(r)[p][tuple(
                    slice(x - b.start, y - b.start)
                    for x, y, b in zip(lo, hi, oreg))]
                t[tuple(slice(x - a.start, y - a.start)
                        for x, y, a in zip(lo, hi, region))] = src
            dev = (device if device is not None else
                   ref.device if torch.is_tensor(ref) else "cpu")
            out.append(t.to(dev))
        return tree_unflatten(like, out)

