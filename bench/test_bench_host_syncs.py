"""The reader ``host_syncs_per_point.surface`` on a synthetic trace: a
``Traced`` whose profiler events are made up, read through the harness's
own window cut (``Traced._read``).  It counts the three synchronising
CUDA runtime calls inside the window, ignores them outside it and every
other host or device event, and reads nothing without points."""
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib.registry import Cell  # noqa: E402
from benchlib.trace import Traced  # noqa: E402

METRIC = "host_syncs_per_point.surface"


class _Event:
    def __init__(self, name, host, start, dur, kind):
        self._v = (name, host, start, dur, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[1]
                else torch.autograd.DeviceType.CUDA)

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]


def _traced(events) -> Traced:
    tr = Traced(False)
    results = types.SimpleNamespace(events=lambda: events)
    tr._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    tr._read()
    return tr


EVENTS = [
    _Event(Traced.WINDOW, True, 100, 900, "user_annotation"),
    _Event("cudaStreamSynchronize", True, 50, 20, "cuda_runtime"),
    _Event("cudaStreamSynchronize", True, 200, 10, "cuda_runtime"),
    _Event("cudaDeviceSynchronize", True, 300, 10, "cuda_runtime"),
    _Event("cudaEventSynchronize", True, 400, 10, "cuda_runtime"),
    _Event("cudaStreamSynchronize", True, 450, 10, "cuda_runtime"),
    _Event("cudaLaunchKernel", True, 500, 5, "cuda_runtime"),
    _Event("aten::item", True, 600, 50, "cpu_op"),
    _Event("cudaMemcpyAsync", True, 700, 5, "cuda_runtime"),
    _Event("cudaStreamSynchronize", True, 1100, 10, "cuda_runtime"),
    _Event("cudaDeviceSynchronize", True, 1200, 10, "cuda_runtime"),
    _Event("gemm", False, 510, 80, "kernel"),
]


@pytest.mark.parametrize("points, want", [(1, 4.0), (2, 2.0), (8, 0.5)])
def test_counts_the_syncs_inside_the_window(points, want):
    read = Cell("qwen2-0.5b.surface-4k").reader(METRIC).read
    run = types.SimpleNamespace(records=[{}] * points,
                                traced=_traced(EVENTS))
    assert read(run) == want


def test_reads_nothing_without_points():
    read = Cell("qwen2-0.5b.surface-4k").reader(METRIC).read
    run = types.SimpleNamespace(records=[], traced=_traced(EVENTS))
    assert read(run) is None


@pytest.mark.parametrize("cell", ["qwen2-0.5b.surface-4k",
                                  "olmoe-1b-7b.surface-4k",
                                  "granite-4.0-h-small.surface-2k"])
def test_every_surface_cell_reports_it(cell):
    assert METRIC in [m["name"] for m in Cell(cell).per_layer]
    assert METRIC not in [m["name"]
                          for m in Cell("qwen2-0.5b.train-4k").per_layer]
