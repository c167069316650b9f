"""Live and moved bytes of an eager step: the port's counterpart of XLA's
``memory_analysis().temp_size_in_bytes`` and ``cost_analysis()["bytes
accessed"]``, which ``launch.dryrun`` reads.

``LiveBytes(*arguments)`` is a ``TorchDispatchMode``.  Every storage that
an op under it returns, and that is not one of the arguments' storages,
counts as live from that op until the storage is freed: a weak reference
on the storage (not on the tensor) removes it, so views of one buffer
count once, however many there are.  ``peak`` is the largest live total
beyond the arguments, at op granularity (an op's own scratch space is
not seen); ``moved`` sums each op's input and output bytes (views move
none), the bytes an eager step reads and writes with no fusion.  It
works on meta tensors as on real ones, so a rank's step at full width is
sized without memory.  Scalars (0-dim results) are not counted: a few
bytes each, where they are made depends on the device (a learning rate
computed on the host is copied to the card and to meta, not on the CPU; a
constant ``torch.tensor(x)`` reaches the dispatcher as ``lift_fresh`` on
some devices and not at all on meta).
"""
from __future__ import annotations

import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._tree import tree_leaves


def _tensors(tree: Any) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """Peak live bytes beyond ``arguments`` (any trees of tensors) and the
    bytes moved, over the ops dispatched inside the mode."""

    def __init__(self, *arguments: Any):
        super().__init__()
        # the arguments' storages, held so their ids stay theirs
        self._arguments = {id(s): s for s in
                           (t.untyped_storage() for t in _tensors(arguments))}
        self._live_ids: set = set()
        self.live = 0
        self.peak = 0
        self.moved = 0

    def _free(self, key: int, nbytes: int) -> None:
        self._live_ids.discard(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        if t.dim() == 0:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._arguments or key in self._live_ids:
            return
        nbytes = st.nbytes()
        self._live_ids.add(key)
        self.live += nbytes
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view:
            self.moved += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.moved += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out
