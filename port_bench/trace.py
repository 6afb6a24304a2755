"""The traced window: torch.profiler over the window, reduced in memory to
what the metric readers and the result line need.

The harness's spans are torch.profiler.record_function ranges around each
call into the program; they land in the profiler's trace with the device's
operations on one clock. Device time is the union of the intervals of
kernels, copies and sets on the card; an idle gap is a stretch of the
window with none, charged to the spans that cover it.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import torch

__all__ = ["Trace", "profiled", "reduce_events"]

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """One traced window. Times in seconds; intervals in the trace's ns."""
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)        # device op name -> seconds
    kernels: dict = field(default_factory=dict)    # kernel name -> seconds
    idle_gaps: dict = field(default_factory=dict)  # span name (or outside) -> seconds

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name `match(name)` accepts."""
        return sum(s for name, s in self.kernels.items() if match(name))

    def breakdown(self, top: int = 10) -> dict:
        def best(d):
            return [[name[:96], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.ops), "idle_gaps": best(self.idle_gaps)}


def profiled():
    """A profiler over the host and the card, started by the caller."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _kind(ev) -> str:
    at = getattr(ev, "activity_type", None)
    if at is not None:
        return str(at() if callable(at) else at)
    if ev.is_user_annotation():
        return "gpu_user_annotation"
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce_events(events, span_names) -> Trace:
    """A Trace from kineto events: the window runs from the first of the
    harness's spans (names in span_names) to the end of the last."""
    spans, device = [], []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(ev)
            if kind in _DEVICE_KINDS:
                device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(), kind))
        elif ev.name() in span_names and ev.is_user_annotation():
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    w_lo = min(s[0] for s in spans)
    w_hi = max(s[1] for s in spans)
    ops = collections.Counter()
    kernels = collections.Counter()
    inside = []
    for lo, hi, name, kind in device:
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi <= lo:
            continue
        ops[name] += (hi - lo) * 1e-9
        if kind == "kernel":
            kernels[name] += (hi - lo) * 1e-9
        inside.append((lo, hi))
    busy = _union(inside)
    gaps, at = [], w_lo
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if at < w_hi:
        gaps.append((at, w_hi))
    idle = collections.Counter()
    spans.sort()
    j = 0
    for g_lo, g_hi in gaps:
        covered = 0
        while j < len(spans) and spans[j][1] <= g_lo:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g_hi:
            over = min(g_hi, spans[k][1]) - max(g_lo, spans[k][0])
            if over > 0:
                idle[spans[k][2]] += over * 1e-9
                covered += over
            k += 1
        if g_hi - g_lo - covered > 0:
            idle["outside_any_span"] += (g_hi - g_lo - covered) * 1e-9
    return Trace(
        window_s=(w_hi - w_lo) * 1e-9,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-9,
        ops=dict(ops), kernels=dict(kernels), idle_gaps=dict(idle),
    )
