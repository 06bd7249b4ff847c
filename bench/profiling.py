"""The measured window, timed on the host, and with `--trace 1` traced on
the card by torch.profiler.

A driver enters its window with `with scope:` right before its first
request and leaves it after its last one has finished on the card; `t0`
and `t1` are host-clock stamps (`time.perf_counter`). The traced window
records the card's activity only (kernels, copies, fills), so the host runs
as in an untraced window but for the profiler's launch callbacks. A marker
kernel launched on an idle card before the window ties the trace's clock
to the host clock, so device intervals and host spans share one time line.

Busy time is the union of the device intervals inside the window (the idle
share is the rest); device operations and kernel times by name are read
from the same events.
"""

from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


class Window:
    """The window on the host clock alone."""

    def __init__(self, device):
        self.device = device
        self.t0 = self.t1 = None

    def __enter__(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.t1 = time.perf_counter()
        return False


class TracedWindow(Window):
    """The window under torch.profiler (CUDA activity only)."""

    def __init__(self, device, rec):
        super().__init__(device)
        self.rec = rec
        self.events: list[tuple[str, float, float]] = []  # (name, start s, end s), host clock

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)  # the trace has been seen to drop the first launch
        torch.cuda.synchronize()
        self._h_marker = time.perf_counter()
        torch.cuda._sleep(1000)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._prof.__exit__(None, None, None)
        self._collect()
        return False

    def _raw(self):
        """(name, start us, duration us) of every device event, on the trace's clock."""
        try:
            evs = self._prof.profiler.kineto_results.events()
            cuda = torch.autograd.DeviceType.CUDA
            return [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
                    for e in evs if e.device_type() == cuda]
        except AttributeError:
            return [(e.name, e.time_range.start, e.time_range.elapsed_us())
                    for e in self._prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]

    def _collect(self):
        raw = sorted(self._raw(), key=lambda e: e[1])
        markers = [e for e in raw if MARKER in e[0]]
        # the last marker is the one launched at `_h_marker` on an idle card
        if markers:
            offset_us = markers[-1][1] - self._h_marker * 1e6
        else:  # no marker recorded: take the first event as the window's start
            offset_us = (raw[0][1] if raw else 0.0) - self.t0 * 1e6
        self.offset_us = offset_us  # the trace's clock less the host clock
        self.events = [(n, (s - offset_us) / 1e6, (s + d - offset_us) / 1e6)
                       for n, s, d in raw if MARKER not in n]
        self.events = [e for e in self.events if e[2] > self.t0 and e[1] < self.t1]
        self.busy_s, self.intervals = _union(self.events, self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernel_s(self, names) -> float:
        """Device seconds of the events whose name holds any of `names`."""
        return sum(min(e, self.t1) - max(s, self.t0) for n, s, e in self.events
                   if any(k in n for k in names))

    def count(self, names=None) -> int:
        if names is None:
            return len(self.events)
        return sum(1 for n, _, _ in self.events if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, s, e in self.events:
            by_name[n] = by_name.get(n, 0.0) + (min(e, self.t1) - max(s, self.t0))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": self.idle_gaps(top)}

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device intervals, each named by the
        innermost host span around its middle."""
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            around = [s for s in self.rec.spans if s[1] <= mid <= s[2]]
            name = min(around, key=lambda s: s[2] - s[1])[0] if around else "outside spans"
            out.append([f"host in {name}", b - a])
        return out


def _union(events, t0, t1):
    """(busy seconds, merged [start, end] intervals) of events clipped to [t0, t1]."""
    merged: list[list[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged
