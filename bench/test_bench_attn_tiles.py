"""The readers ``attn_tiles_per_step.train`` and ``attn_ms.train``: a
profiled CPU run of a small causal chunked attention, forward and backward
under the model's remat, counts each tile of the plan twice a step (the
forward and the backward's recompute); a trace without the program's span
reads nothing; kernels count by their launch's correlation id."""
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib.registry import Cell  # noqa: E402
from benchlib.trace import Traced  # noqa: E402

CELL = "qwen2-0.5b.train-4k"
TILES, MS = "attn_tiles_per_step.train", "attn_ms.train"


def _traced_steps(monkeypatch, fn_name: str, steps: int):
    """``steps`` forward + backward passes of one attention call under
    remat, each in a ``bench.step`` span, in a traced window."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    monkeypatch.setattr(A, "KV_CHUNK", 16)
    cfg = registry.smoke_config("qwen2-0.5b")
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 16), generator=g).requires_grad_()
    k = torch.randn((2, 64, 2, 16), generator=g).requires_grad_()
    v = torch.randn((2, 64, 2, 16), generator=g).requires_grad_()
    fn = getattr(A, fn_name)

    def body(q, k, v):
        return fn(q, k, v, cfg, causal=True, window=None)

    tr = Traced(True)
    with tr:
        with tr.window():
            for _ in range(steps):
                with torch.profiler.record_function("bench.step"):
                    o = M._maybe_remat(body, True, q, k, v)
                    torch.autograd.grad(o.sum(), (q, k, v))
    return (types.SimpleNamespace(records=[{}] * steps, traced=tr, info={}),
            A.tile_plan(64, 64, 0, True, None))


@pytest.mark.parametrize("steps", [1, 2])
def test_counts_the_forward_and_recompute_tiles(monkeypatch, steps):
    run, plan = _traced_steps(monkeypatch, "chunked_attention", steps)
    live = sum(len(p) for p in plan)
    assert live == 10           # 4 query blocks of 16 over 4 key chunks
    assert Cell(CELL).reader(TILES).read(run) == 2 * live
    # the CPU run launches nothing on a device
    assert Cell(CELL).reader(MS).read(run) is None


def test_reads_nothing_without_the_span(monkeypatch):
    run, _ = _traced_steps(monkeypatch, "full_attention", 1)
    assert Cell(CELL).reader(TILES).read(run) is None
    assert Cell(CELL).reader(MS).read(run) is None


@pytest.mark.parametrize("metric", [TILES, MS])
def test_reads_nothing_untraced_or_without_steps(metric):
    read = Cell(CELL).reader(metric).read
    assert read(types.SimpleNamespace(records=[], traced=None)) is None
    assert read(types.SimpleNamespace(records=[{}], traced=None)) is None


class _Event:
    def __init__(self, name, host, start, dur, corr, kind):
        self._v = (name, host, start, dur, corr, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[1]
                else torch.autograd.DeviceType.CUDA)

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


class _UntypedEvent(_Event):
    """An event of a profiler that gives no activity type (PyTorch 2.11)."""
    activity_type = None


@pytest.mark.parametrize("typed", [True, False])
def test_attn_ms_links_kernels_to_launches_in_the_span(typed):
    """Kernels count by their launch's correlation id, whenever they run,
    once under nested spans; a CPU operator's id, a launch outside the
    span, a span outside the window and the device's mirror of the span do
    not count."""
    read = Cell(CELL).reader(MS)
    cls = _Event if typed else _UntypedEvent
    ev = [cls("repro.attn.tile", True, 100, 50, 1, "user_annotation"),
          cls("repro.attn.tile", True, 101, 48, 3, "user_annotation"),
          cls("cudaLaunchKernel", True, 110, 5, 7, "cuda_runtime"),
          cls("aten::bmm", True, 112, 5, 8, "cpu_op"),
          cls("cudaLaunchKernel", True, 160, 5, 9, "cuda_runtime"),
          cls("repro.attn.tile", True, 900, 50, 2, "user_annotation"),
          cls("cudaLaunchKernel", True, 910, 5, 10, "cuda_runtime"),
          cls("gemm", False, 400, 30, 7, "kernel"),
          cls("copy", False, 450, 30, 8, "kernel"),
          cls("exp", False, 480, 30, 9, "kernel"),
          cls("late", False, 960, 30, 10, "kernel"),
          cls("repro.attn.tile", False, 100, 500, 7, "gpu_user_annotation")]
    assert read.span_device_ns(ev, 0, 500) == (30, 1)
    assert read.span_device_ns(ev, 0, 1000) == (60, 2)


@pytest.mark.parametrize("cell", ["qwen2-0.5b.surface-4k",
                                  "olmoe-1b-7b.surface-4k",
                                  "granite-4.0-h-small.surface-2k"])
def test_only_the_training_cell_reports_them(cell):
    for metric in (TILES, MS):
        assert metric in [m["name"] for m in Cell(CELL).per_layer]
        assert metric not in [m["name"] for m in Cell(cell).per_layer]
