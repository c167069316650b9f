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

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch._tree import tree_leaves_with_paths, tree_unflatten


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
