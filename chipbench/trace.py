"""The device trace of a run's window, and the benchmark's own host spans.

:class:`DeviceTrace` runs ``torch.profiler`` over CUDA activity only and
returns every device operation (kernels, copies, fills) as ``(name,
start, end)`` in seconds of the host's ``time.perf_counter``: the
profiler's clock is tied to the host's by a marker kernel launched between
two host readings right after the profiler starts.

:class:`Spans` records the benchmark's spans around its calls into the
program, in the same host seconds.  Idle gaps on the device are named by
the innermost span that holds them, so the breakdown says what the host
was doing while the device waited.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Spans:
    items: list = field(default_factory=list)   # (name, start, end)

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def within(self, name: str, w0: float, w1: float) -> list:
        return [(s, e) for n, s, e in self.items
                if n == name and s >= w0 and e <= w1]


class DeviceTrace:
    """Context manager: the device operations run while it is open."""

    def __init__(self, device) -> None:
        self.device = device
        self.ops: list = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # the marker: the first device operation of the trace
        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._before = time.perf_counter()
        marker.add_(1)
        torch.cuda.synchronize(self.device)
        self._after = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        events.sort(key=lambda e: e.start_ns())
        if not events:
            return
        # the marker ran between the two host readings: its start is put
        # at their midpoint
        offset = events[0].start_ns() / 1e9 - (self._before
                                                + self._after) / 2
        self.ops = [(e.name(), e.start_ns() / 1e9 - offset,
                     (e.start_ns() + e.duration_ns()) / 1e9 - offset)
                    for e in events[1:]]


def clip(ops, w0: float, w1: float) -> list:
    """Device operations cut to the window [w0, w1]."""
    return [(n, max(s, w0), min(e, w1)) for n, s, e in ops
            if e > w0 and s < w1]


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    merged: list = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_seconds(ops, w0: float, w1: float) -> float:
    return float(sum(e - s for s, e in busy_intervals(clip(ops, w0, w1))))


def kernel_seconds(ops, w0: float, w1: float, part: str) -> float:
    """Device seconds of the operations whose name holds ``part``."""
    return float(sum(e - s for n, s, e in clip(ops, w0, w1) if part in n))


def idle_gaps(ops, w0: float, w1: float) -> list:
    """The window's stretches with nothing running on the device."""
    gaps, t = [], w0
    for s, e in busy_intervals(clip(ops, w0, w1)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _labels(spans: Spans, points) -> list:
    """For each of the sorted ``points``, the innermost span holding it
    (spans nest or are disjoint), or ``"harness"`` outside them all."""
    items = sorted(spans.items, key=lambda x: x[1])
    out, stack, j = [], [], 0
    for t in points:
        while j < len(items) and items[j][1] <= t:
            stack.append(items[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else "harness")
    return out


def breakdown(ops, spans: Spans, w0: float, w1: float,
              top: int = 10) -> dict:
    """The device operations that took most time, and idle time by what
    the host was doing (the innermost benchmark span around each gap),
    each list the ``top`` largest, in seconds."""
    by_op: dict = {}
    for n, s, e in clip(ops, w0, w1):
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    gaps = idle_gaps(ops, w0, w1)
    by_label: dict = {}
    for (s, e), label in zip(gaps, _labels(spans,
                                           [(s + e) / 2 for s, e in gaps])):
        by_label[label] = by_label.get(label, 0.0) + (e - s)

    def largest(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": largest(by_op), "idle_gaps": largest(by_label)}


def nearest_rank(values, q: float) -> float | None:
    """The q-quantile by nearest rank: the smallest value with at least
    q of the values at or below it."""
    if len(values) == 0:
        return None
    v = np.sort(np.asarray(values, dtype=np.float64))
    rank = max(1, int(np.ceil(q * len(v) - 1e-9)))
    return float(v[rank - 1])


def idle_pct(facts: dict) -> float | None:
    """The share of the traced window in which no operation ran on the
    device, in percent, from a driver's ``busy_s`` and
    ``trace_window_s``."""
    if not facts.get("trace_window_s") or "busy_s" not in facts:
        return None
    return (1.0 - facts["busy_s"] / facts["trace_window_s"]) * 100.0
