"""The device trace of a measured window, from ``torch.profiler``.

``Traced`` wraps the window in a profiler (CPU and CUDA activity, no
shapes, no stacks) and keeps, once it closes, two flat lists in
nanoseconds on the profiler's clock: device operations (kernels, copies,
sets) and host spans (the benchmark's own ``record_function`` spans and
the operators inside them).  The readers in ``bench/metrics`` take their
numbers from these lists.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def span(name: str):
    """A host span around a call into one layer (``record_function``)."""
    return record_function(name)


class Event:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: int, end: int):
        self.name, self.start, self.end = name, start, end

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120        # a kernel's name in the breakdown, cut to this


def _raw_events(prof):
    """(name, on the host, start ns, end ns) of every event; of the device's
    events only work (kernels, copies, sets), not the annotations that
    mirror host spans (where the profiler gives no activity type, a device
    event named as a host event is such an annotation)."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in events if e.device_type() == cpu}
    out = []
    for e in events:
        host = e.device_type() == cpu
        if not host:
            kind = getattr(e, "activity_type", None)
            if kind is not None and kind() not in DEVICE_WORK:
                continue
            if kind is None and e.name() in host_names:
                continue
        out.append((e.name(), host, e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out


def union_ns(events) -> int:
    """Length of the union of the events' intervals."""
    busy, cur_s, cur_e = 0, None, None
    for e in sorted(events, key=lambda e: e.start):
        if cur_e is None or e.start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = e.start, e.end
        else:
            cur_e = max(cur_e, e.end)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class Traced:
    """``with Traced() as tr:`` profiles the block; afterwards
    ``tr.device`` / ``tr.host`` hold the events inside the span that
    ``tr.window()`` opens."""

    WINDOW = "bench.window"

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.device, self.host = [], []
        self.window_ns = 0
        self.read_s = 0.0

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        if self.enabled:
            self._prof = self._stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=False, with_stack=False))
        return self

    def window(self):
        """The measured window's own span (a no-op when not tracing)."""
        return (record_function(self.WINDOW) if self.enabled
                else contextlib.nullcontext())

    def __exit__(self, *exc):
        self._stack.close()
        if self.enabled and exc[0] is None:
            t0 = time.perf_counter()
            self._read()
            self.read_s = time.perf_counter() - t0
        return False

    def _read(self):
        raw = _raw_events(self._prof)
        win = [r for r in raw if r[0] == self.WINDOW and r[1]]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win[0][2], win[0][3]
        self.window_ns = w1 - w0
        for name, host, s, e in raw:
            if e < w0 or s > w1:
                continue
            ev = Event(name, max(s, w0), min(e, w1))
            if host:
                if name != self.WINDOW:
                    self.host.append(ev)
            else:
                self.device.append(ev)
        self.device.sort(key=lambda e: e.start)
        self.host.sort(key=lambda e: e.start)
        self.w0, self.w1 = w0, w1

    # -- what the readers and the result line take ---------------------------
    @property
    def window_s(self) -> float:
        return self.window_ns * 1e-9

    @property
    def busy_s(self) -> float:
        return union_ns(self.device) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = self.w0
        for e in self.device + [Event("", self.w1, self.w1)]:
            if e.start > prev:
                gaps.append((prev, e.start))
            prev = max(prev, e.end)
        gaps.sort(key=lambda g: g[0] - g[1])
        out_gaps = []
        for g0, g1 in gaps[:top]:
            mid = (g0 + g1) // 2
            inside = [h for h in self.host if h.start <= mid <= h.end]
            label = (min(inside, key=lambda h: h.end - h.start).name
                     if inside else "no host span")
            out_gaps.append([label, (g1 - g0) * 1e-9])
        return {"device_ops": [[n[:NAME_CHARS], ns * 1e-9] for n, ns in ops],
                "idle_gaps": out_gaps}
