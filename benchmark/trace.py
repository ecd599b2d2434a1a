"""The traced run's device timeline, read from ``torch.profiler``.

Only device activity is recorded (kernels, copies, fills): a decode step
launches thousands of kernels, and CPU operator events would multiply the
trace. Events are put on the harness's clock (seconds from the window's
start) by a marker: one small kernel launched on an idle device just
before the window, whose start is taken as the host time of its launch
(off by the launch latency, some microseconds).
"""

from __future__ import annotations

import time

import torch

_SKIP_PREFIXES = ("Memcpy", "Memset")


class Tracer:
    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self.prof = None
        self.events = None  # [(name, start_s, dur_s)] sorted by start
        self.window_s = None

    def start(self):
        """Start tracing and launch the marker; call just before the window."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._marker_host = time.perf_counter()
        torch.zeros(1, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def stop(self, t0: float, t1: float):
        """Stop and keep the device events of the window [t0, t1] (harness
        clock, ``time.perf_counter``), on the window's clock."""
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.stop()
        dev = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events() if e.device_type() == dev]
        self.prof = None
        raw.sort(key=lambda x: x[1])
        evs = []
        if raw:
            base = raw[0][1]  # the marker
            shift = self._marker_host - t0
            for name, s, d in raw[1:]:
                evs.append((name, shift + (s - base) * 1e-9, d * 1e-9))
        self.events = [e for e in evs if e[1] >= 0.0]
        self.window_s = t1 - t0


def kernels(events):
    """The kernels among device events (no copies or fills)."""
    return [e for e in events if not e[0].startswith(_SKIP_PREFIXES)]


def busy_intervals(events):
    """Merged [start, end] intervals in which some device operation ran."""
    out = []
    for _, s, d in events:
        e = s + d
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_s(events) -> float:
    return sum(e - s for s, e in busy_intervals(events))


def idle_gaps(events, window_s: float):
    """[(start, length)] of the device's idle time in [0, window_s]."""
    gaps, at = [], 0.0
    for s, e in busy_intervals(events):
        if s > at:
            gaps.append((at, min(s, window_s) - at))
        at = max(at, e)
    if at < window_s:
        gaps.append((at, window_s - at))
    return [g for g in gaps if g[1] > 0]


def span_at(spans, t: float) -> str:
    """The name of the harness span that holds time ``t`` ("host" between
    spans). ``spans``: [(name, start, end)] sorted by start."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] <= t:
            lo = mid + 1
        else:
            hi = mid
    if lo and spans[lo - 1][1] <= t < spans[lo - 1][2]:
        return spans[lo - 1][0]
    return "host"


def breakdown(events, spans, window_s: float, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by the harness span it fell in."""
    by_name = {}
    for name, _, d in events:
        key = name if len(name) <= 120 else name[:117] + "..."
        by_name[key] = by_name.get(key, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = {}
    for start, length in idle_gaps(events, window_s):
        name = span_at(spans, start)
        idle[name] = idle.get(name, 0.0) + length
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
