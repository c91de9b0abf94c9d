"""Spans on the port's own phases, in the torch profiler's trace.

`span(name)` is `torch.profiler.record_function(name)` while the torch
profiler records, and one shared null context otherwise. The spans land
in the same trace as the device's kernels and copies, on the same clock,
whoever runs the profiler; nothing is exported or configured here. With
no profiler running a span costs one check of the profiler's state (a
`record_function` built regardless costs several microseconds a span).
Every name starts with `vss.`.

`PhaseClock` times a sequence of phases, each also a span: on CUDA by
events recorded at the phase boundaries and read once at the end, so no
phase waits for the device; on the CPU by the host clock.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["span", "PhaseClock"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function` span named `name` while the profiler records,
    else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class PhaseClock:
    """Seconds of each phase of a sequence (`phase(name)`), each also the
    span `prefix + name`."""

    def __init__(self, device: torch.device, prefix: str):
        self.device = device
        self.prefix = prefix
        self._marks: list = []  # (name, start, end): events on CUDA, else seconds

    def _now(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    @contextlib.contextmanager
    def phase(self, name: str):
        start = self._now()
        with span(self.prefix + name):
            yield
        self._marks.append((name, start, self._now()))

    def seconds(self) -> dict:
        """{phase: seconds}. On CUDA this waits for the last phase's end
        event, once."""
        if self.device.type != "cuda":
            return {n: e - s for n, s, e in self._marks}
        if self._marks:
            self._marks[-1][2].synchronize()
        return {n: s.elapsed_time(e) * 1e-3 for n, s, e in self._marks}
