"""Device milliseconds per training step in the kernels launched inside
the program's ``repro.attn.tile`` spans (the computed tiles of the chunked
attention's forward and of its recompute in the backward, nested where one
key chunk's work covers several; autograd launches the backward's own
kernels outside the spans), over the traced window.  Each device operation
is linked to its launch on the host by the profiler's correlation id: the
launches (CUDA runtime and driver calls) that start inside a span name the
kernels, copies and sets that are the tiles'.  The operations per step are
printed beside it.  A program without the span reads nothing."""
import bisect

import torch

from benchlib.trace import DEVICE_WORK

SPAN = "repro.attn.tile"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _kind(e):
    """The event's activity type, or None where the profiler's events have
    none (PyTorch 2.11's kineto events)."""
    kind = getattr(e, "activity_type", None)
    return kind() if kind is not None else None


def _is_launch(e) -> bool:
    kind = _kind(e)
    if kind is not None:
        return kind in LAUNCH_KINDS
    # without types: the CUDA runtime and driver calls, not the operators
    return e.name().startswith("cu")


def _is_work(e, host_names) -> bool:
    """A kernel, copy or set, not the device's mirror of a host span."""
    kind = _kind(e)
    if kind is not None:
        return kind in DEVICE_WORK
    return e.name() not in host_names


def span_device_ns(events, w0: int, w1: int) -> tuple:
    """(device ns, device operations) launched inside the spans that start
    in the window [w0, w1] of the profiler's ``events`` (of nested spans,
    the innermost holds the launch; each operation counts once)."""
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.device_type() == cpu
                   and e.name() == SPAN and w0 <= e.start_ns() <= w1)
    if not spans:
        return 0, 0
    starts = [s for s, _ in spans]
    host_names = {e.name() for e in events if e.device_type() == cpu}
    ids = set()
    for e in events:
        if e.device_type() != cpu or not _is_launch(e):
            continue
        t = e.start_ns()
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            ids.add(e.correlation_id())
    ns = ops = 0
    for e in events:
        if (e.device_type() == cpu or e.correlation_id() not in ids
                or not _is_work(e, host_names)):
            continue
        ns += e.duration_ns()
        ops += 1
    return ns, ops


def read(run):
    n = len(run.records)
    prof = getattr(run.traced, "_prof", None)
    if not n or prof is None:
        return None
    ns, ops = span_device_ns(prof.profiler.kineto_results.events(),
                             run.traced.w0, run.traced.w1)
    if not ops:
        return None
    run.info["attn_tile_ops_per_step"] = ops / n
    return 1e-6 * ns / n
