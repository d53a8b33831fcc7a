"""The port's one per-job record of spans and counters.

``TIMINGS`` is a flat dict of numbers, emptied at the start of every
``controller.hmm_controller_multiple`` (``reset``).  ``with span(name):``
adds its seconds (``time.perf_counter``) to ``TIMINGS[name]`` and 1 to
``TIMINGS[name + ".calls"]``; ``count(name, n)`` adds ``n`` to a counter.
While a ``torch.profiler`` records the calling thread, the span is also a
``record_function`` range ``tagdust.<name>``, on the profiler's clock; the
profiler records the thread that started it, so the reader's and writer's
spans reach the record alone.

Rules: each key is written by one thread only, and no span or count goes
inside a loop over reads.  ``detection`` (the seconds of ``-arch``
detection, 0.0 without it) and ``calibration`` (the stats pre-pass plus
threshold calibration, None where this host did not run them) keep the
meaning they had before the other spans.
"""

from __future__ import annotations

import time

import torch

TIMINGS = {}

# thread-local: true only on a thread the active profiler records
_recording = torch._C._autograd._profiler_enabled


def reset() -> None:
    TIMINGS.clear()
    TIMINGS.update(detection=0.0, calibration=None)


def count(name: str, n=1) -> None:
    TIMINGS[name] = TIMINGS.get(name, 0) + n


class span:
    """A span over a ``with`` block; see the module's docstring."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _recording():
            self.rf = torch.profiler.record_function("tagdust." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        count(self.name, dt)
        count(self.name + ".calls")


reset()
