"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: device time by kernel and by copy kind, the busy
share of the window, and the idle gaps by what the host was doing.

The window is the span from the start of the first traced call to the end
of the last (their ``record_function`` ranges, ``CALL``); device events
are clipped to it.
"""
from dataclasses import dataclass, field

import numpy as np

# The harness's own ranges: one call of the entry, and the harness's work
# between calls (reading the checked points of the output).
CALL = "lblbench.call"
BETWEEN = "lblbench.sample"
# Host ranges searched back from a gap for the innermost one open over it
# (a call's own range, opened earlier, is found apart).
LOOK_BACK = 4096


@dataclass
class Trace:
    """Device activity of the traced window: ``kernels`` and ``copies``
    are (name, start_us, end_us) lists, ``cpu`` the host ranges (name,
    start_us, end_us), ``calls`` the number of calls."""
    kernels: list
    copies: list
    cpu: list
    calls: int
    window: tuple
    busy_us: float = field(init=False)

    def __post_init__(self):
        self.busy_us = _union(self.kernels + self.copies, *self.window)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self):
        return self.busy_us / 1e6

    def kernel_s(self, match):
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(hi - lo for name, lo, hi in self.kernels
                   if match(name)) / 1e6

    def copy_s(self, kind):
        """Seconds of the copies whose name holds ``kind`` ("DtoH",
        "HtoD", "Memset")."""
        return sum(hi - lo for name, lo, hi in self.copies
                   if kind in name) / 1e6

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        totals = {}
        for name, lo, hi in self.kernels + self.copies:
            totals[name] = totals.get(name, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[host activity, seconds]]: the window's idle gaps, each labelled
        by the innermost host range open at its middle (a torch operation,
        a CUDA runtime call, or the call's own range when no operation was
        open), summed by label."""
        gaps = _gaps(self.kernels + self.copies, *self.window)
        order = sorted(range(len(self.cpu)), key=lambda i: self.cpu[i][1])
        names = [self.cpu[i][0] for i in order]
        starts = np.asarray([self.cpu[i][1] for i in order], np.float64)
        ends = np.asarray([self.cpu[i][2] for i in order], np.float64)
        calls = [(lo, hi) for name, lo, hi in self.cpu if name == CALL]
        totals = {}
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            last = int(np.searchsorted(starts, mid, side="right"))
            first = max(0, last - LOOK_BACK)
            open_ = np.flatnonzero(ends[first:last] > mid)
            label = names[first + open_[-1]] if open_.size else CALL \
                if any(a <= mid < b for a, b in calls) else None
            if label == CALL:
                label = "host Python inside the call (no torch op open)"
            elif label is None:
                label = "host outside any range"
            totals[label] = totals.get(label, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _merged(spans, lo, hi):
    """The union of ``spans`` (name, start, end) clipped to [lo, hi], as
    sorted disjoint (start, end) intervals."""
    out = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union(spans, lo, hi):
    return sum(b - a for a, b in _merged(spans, lo, hi))


def _gaps(spans, lo, hi):
    out, edge = [], lo
    for a, b in _merged(spans, lo, hi):
        if a > edge:
            out.append((edge, a))
        edge = b
    if hi > edge:
        out.append((edge, hi))
    return out


def from_profile(prof, calls):
    """A :class:`Trace` from a finished ``torch.profiler.profile`` over
    ``calls`` calls, each inside a ``record_function(CALL)`` range."""
    import torch

    kernels, copies, cpu = [], [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in (CALL, BETWEEN) \
                or getattr(e, "is_user_annotation", False):
            # A range's copy on the device's timeline: no device work.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                cpu.append(span)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            lowered = e.name.lower()
            (copies if "memcpy" in lowered or "memset" in lowered
             else kernels).append(span)
        else:
            cpu.append(span)
    ranges = [c for c in cpu if c[0] == CALL]
    if not ranges:
        raise RuntimeError("the trace holds no call range")
    window = (min(c[1] for c in ranges), max(c[2] for c in ranges))
    return Trace(kernels=kernels, copies=copies, cpu=cpu, calls=calls,
                 window=window)
