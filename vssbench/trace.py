"""The traced sub-window: `torch.profiler` over a few steps of the
window, reduced to device operations, the benchmark's own spans and the
host's work.

Each request of a traced step runs inside a `record_function` span named
`vssbench.<op>`. A device operation belongs to the span whose time holds
the host call that launched it (the trace's correlation ids), so the
work of a request is found whatever kernels the program runs. Device
operations are kernels, copies and memsets; the traced window runs from
the first span's start to the last span's end, and every request ends
with its result on the host, so its device work lies inside it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PREFIX = "vssbench."


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The reduced trace. Times in microseconds on the trace's clock."""

    def __init__(self, events: list):
        launch_ts = {}
        self.device = []   # (name, cat, ts, dur, correlation)
        self.host = []     # (name, ts, dur), the spans among them
        self.spans = []    # (kind, ts, end)
        for ev in events:
            cat = ev.get("cat", "")
            if ev.get("ph") != "X":
                continue
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in _DEVICE_CATS:
                self.device.append((ev["name"], cat, ts, dur, args.get("correlation")))
            elif cat in _HOST_CATS:
                if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                    launch_ts[args["correlation"]] = ts
                if cat == "user_annotation" and ev["name"].startswith(PREFIX):
                    self.spans.append((ev["name"][len(PREFIX):], ts, ts + dur))
                self.host.append((ev["name"], ts, dur))
        self.spans.sort(key=lambda s: s[1])
        self.launches = sorted(launch_ts.values())
        starts = [s[1] for s in self.spans]
        # each device operation -> index of its span, or None
        self.owner = []
        for name, cat, ts, dur, corr in self.device:
            t = launch_ts.get(corr, ts)
            i = bisect.bisect_right(starts, t) - 1
            self.owner.append(i if i >= 0 and t <= self.spans[i][2] else None)
        if self.spans:
            self.t0 = self.spans[0][1]
            self.t1 = max(s[2] for s in self.spans)
        elif self.launches:
            # a trace of the device alone: from the first launch to the end
            # of the last device operation (every request ends on the host)
            self.t0 = self.launches[0]
            self.t1 = max([d[2] + d[3] for d in self.device] + [self.launches[-1]])
        else:
            self.t0 = self.t1 = 0.0

    # ---------------------------------------------------------------- spans
    def calls(self, kind: str) -> int:
        return sum(1 for s in self.spans if s[0] == kind)

    def ops_of(self, kind: str, cats=_DEVICE_CATS):
        """Device operations launched inside spans of `kind`."""
        return [d for d, o in zip(self.device, self.owner)
                if o is not None and self.spans[o][0] == kind and d[1] in cats]

    # --------------------------------------------------------------- window
    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def _clipped(self, ops):
        return [(max(d[2], self.t0), min(d[2] + d[3], self.t1)) for d in ops
                if d[2] + d[3] > self.t0 and d[2] < self.t1]

    def busy_us(self, ops=None) -> float:
        return union_us(self._clipped(self.device if ops is None else ops))

    # ------------------------------------------------------------ breakdown
    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for name, cat, ts, dur, _ in self.device:
            if ts < self.t1 and ts + dur > self.t0:
                by[name] += dur * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle time of the device in the window, summed by what the host
        was doing when each gap began (its innermost event)."""
        busy = merged(self._clipped(self.device))
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = defaultdict(float)
        for s, e in gaps:
            label = "(none)"
            i = bisect.bisect_right(starts, s)
            best = None
            # the innermost host event holding s: the latest start that ends after s
            for j in range(i - 1, max(-1, i - 400), -1):
                name, ts, dur = host[j]
                if ts + dur >= s:
                    best = name
                    break
            if best is not None:
                label = best
            by[label] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]


def untraced_idle_share(outcome, device_trace, steps_traced: int):
    """The device's idle share in the window's untraced steps: 1 - the
    device's busy time a step (the trace of the device alone, over the
    `steps_traced` steps it holds) x those steps' number / their seconds
    on the host clock. The profiler's cost to the host stays out of it.
    None where there is no such trace or no untraced step."""
    if device_trace is None or not device_trace.device or steps_traced <= 0:
        return None
    spans: dict = {}
    for o in outcome.ops:
        if o.phase == "window":
            s = spans.setdefault(o.step, [o.t0, o.t1, o.profiled])
            s[0], s[1] = min(s[0], o.t0), max(s[1], o.t1)
    n, seconds = 0, 0.0
    for s, (t0, t1, profiled) in spans.items():
        if profiled:
            continue
        nxt = spans.get(s + 1)
        # a step lasts until the next one starts (the loop's own time is in
        # it), or to its end where the profiler starts or stops after it
        seconds += (nxt[0] if nxt is not None and not nxt[2] else t1) - t0
        n += 1
    if not n or seconds <= 0:
        return None
    busy_step_s = device_trace.busy_us() * 1e-6 / steps_traced
    return 1.0 - busy_step_s * n / seconds


class Tracer:
    """Profiles two parts of the window in turn (see `loop.Loop.window`).

    The first, `device`, records the device alone (CUPTI's kernels,
    copies and launch calls), which costs the host little: the device's
    busy time and idle share come from it. The second, `full`, adds the
    host's operators and the benchmark's spans, which cost the host
    several microseconds an operator: what each request runs on the
    device, and what the host did in each idle gap, come from it."""

    PHASES = ("device", "full")

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.phase = None
        self.traces: dict = {}

    @property
    def trace(self):
        return self.traces.get("full")

    @property
    def device_trace(self):
        return self.traces.get("device")

    def _activities(self, phase="full"):
        acts = [] if phase == "device" else [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts or [torch.profiler.ProfilerActivity.CPU]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """Set-up: one short profile of each kind, so that the profiler's
        own start-up falls outside the window."""
        for phase in self.PHASES:
            with torch.profiler.profile(activities=self._activities(phase)):
                torch.ones(8, device=self.device).sum().item()

    def start(self, phase: str):
        self._sync()
        self.phase = phase
        self.prof = torch.profiler.profile(activities=self._activities(phase))
        self.prof.__enter__()
        # the profiler's clock for the card can lag the host's a little:
        # leave room so that no kernel of the first span falls before it
        time.sleep(0.05)

    def stop(self):
        self._sync()
        time.sleep(0.05)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="vssbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.traces[self.phase] = Trace(events)
        self.phase = None

    def span(self, kind: str):
        if self.phase != "full":
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + kind)
