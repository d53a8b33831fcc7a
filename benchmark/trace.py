"""Spans around the program's layers, and the reading of the device trace.

``Spans`` wraps calls into the program (the benchmark's own wrappers, as
``bench/e2e.py`` times its stages): each call's seconds add to its name,
and in a traced run each call is also a ``torch.profiler.record_function``
range named ``bench.<name>``, so the trace can say what the host was doing
while the device idled.

``summarize`` reads a ``torch.profiler`` run over the window: the device
operations (kernels, copies, sets), the union of their intervals inside the
jobs (``busy_seconds`` is ``profile_smoke.py:busy_seconds``, copied, with
the intervals clipped to the jobs), and the idle gaps labelled by the span
the main thread had open.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

MAIN_SPANS = ("detection", "stats", "calibration", "label")


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            import torch

            rf = torch.profiler.record_function("bench." + name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1

    def wrap(self, name: str, fn, on_return=None):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with self.span(name):
                out = fn(*a, **k)
            if on_return is not None:
                on_return(out, a, k)
            return out

        return wrapped

    def take(self) -> dict:
        """The seconds since the last take, by name."""
        out = dict(self.seconds)
        self.seconds.clear()
        self.calls.clear()
        return out


def busy_seconds(intervals) -> float:
    """The union of ``(start, end)`` intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """{"jobs": [(start, end)], "device": [(name, start, end)], "busy_s",
    "window_s", "gaps": [(label, seconds)]} of a profiled window; times in
    seconds of the profiler's clock."""
    from torch.autograd import DeviceType

    device, spans = [], []
    # the raw events: building ``prof.events()``' tree of a window's
    # hundreds of thousands of events takes minutes
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
        if name.startswith("bench."):
            # the spans' host ranges; their mirrors on the device's
            # timeline are annotations, not operations
            if e.device_type() != DeviceType.CUDA:
                spans.append((name[6:], a, b))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((name, a, b))
    jobs = sorted((a, b) for n, a, b in spans if n == "job")
    clipped = []
    for _, a, b in device:
        for ja, jb in jobs:
            lo, hi = max(a, ja), min(b, jb)
            if hi > lo:
                clipped.append((lo, hi))
    busy = busy_seconds(clipped)
    window = sum(b - a for a, b in jobs)
    merged = _merged(clipped)
    main = [(n, a, b) for n, a, b in spans if n in MAIN_SPANS]
    gaps = []
    for ja, jb in jobs:
        inside = [iv for iv in merged if iv[1] > ja and iv[0] < jb]
        edges = [ja] + [x for iv in inside for x in iv] + [jb]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "other host work"
            for n, sa, sb in main:
                if sa <= mid <= sb:
                    label = n
            gaps.append((label, b - a))
    return {"jobs": jobs, "device": device, "busy_s": busy, "window_s": window,
            "gaps": gaps}


def device_op_seconds(summary: dict) -> list:
    """[(name, seconds)] of the device operations inside the jobs, summed
    by name, largest first."""
    tot = defaultdict(float)
    for name, a, b in summary["device"]:
        for ja, jb in summary["jobs"]:
            lo, hi = max(a, ja), min(b, jb)
            if hi > lo:
                tot[name] += hi - lo
    return sorted(tot.items(), key=lambda kv: -kv[1])


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] not in " :":
            return name[:i]
    return name
