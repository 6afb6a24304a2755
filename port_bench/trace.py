"""The traced window: torch.profiler over the window, reduced in memory to
what the metric readers and the result line need.

Two kinds of span land in the profiler's trace with the device's
operations, on one clock: the harness's, torch.profiler.record_function
ranges around each call into the program (a driver's SPANS and
run.RECORD_SPAN), and the port's own, the ranges of
kgl_gene_tpu_torch/tracing.py at each stage of a call, named kgt.*.
reduce_events keeps:
  - window_s: from the start of the first harness span to the end of the
    last; the port's spans do not move it;
  - busy_s: the union of the intervals of kernels, copies and sets on the
    card inside the window; ops and kernels: each one's seconds there;
  - idle_gaps: each stretch of the window with none, charged to the
    innermost span that covers it, the harness's or the port's
    (`outside_any_span` where none does); the harness's spans do not nest;
  - span_s: each span name's host seconds inside the window;
  - span_device_s: the device seconds of the kernels, copies and sets
    launched inside each span, charged to the innermost span that holds
    the launch's start (`outside_any_span` where none does). A device op
    shares its correlation id with the runtime or driver call that
    launched it (CUPTI's id); where the trace holds no such call, the
    host op its linked_correlation_id names stands in. That id is the
    host op's own, from another count, so the two are never mixed; and
    the port's kernels, launched through ctypes under no aten op, have no
    link at all, so the link alone would leave B1 and B2 unlinked;
  - unlinked_s: the device seconds whose launch the trace holds neither way.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

import torch

__all__ = ["OUTSIDE", "PREFIX", "Trace", "innermost_segments", "profiled", "reduce_events"]

PREFIX = "kgt."
OUTSIDE = "outside_any_span"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """One traced window. Times in seconds; intervals in the trace's ns."""
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)            # device op name -> seconds
    kernels: dict = field(default_factory=dict)        # kernel name -> seconds
    idle_gaps: dict = field(default_factory=dict)      # innermost span (or outside) -> seconds
    span_s: dict = field(default_factory=dict)         # span name -> host seconds
    span_device_s: dict = field(default_factory=dict)  # span name -> device seconds launched
    unlinked_s: float = 0.0                            # device seconds with no launch found

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name `match(name)` accepts."""
        return sum(s for name, s in self.kernels.items() if match(name))

    def unlinked_share(self) -> float:
        """The share of the window's device seconds whose launch was not found."""
        device_s = sum(self.ops.values())
        return self.unlinked_s / device_s if device_s > 0 else 0.0

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


def _is_launch(ev) -> bool:
    """A runtime or driver call on the host (cudaLaunchKernel,
    cudaMemcpyAsync, cuLaunchKernel, ...): by its activity type where the
    event has one, else by its name (torch 2.11's events have no type)."""
    at = getattr(ev, "activity_type", None)
    if at is not None:
        return str(at() if callable(at) else at) in _LAUNCH_KINDS
    return ev.name().startswith("cu") and not ev.is_user_annotation()


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def innermost_segments(spans):
    """(lo, hi, name) pieces of the spans' extent, each named after the
    innermost span open there: of the open spans, the one opened last
    (the shorter of two opened at once). Stretches with no span open are
    left out. spans: (lo, hi, name)."""
    bounds = sorted([(lo, 1, -hi, i) for i, (lo, hi, _n) in enumerate(spans)]
                    + [(hi, 0, 0, i) for i, (_lo, hi, _n) in enumerate(spans)])
    segments, stack, prev = [], [], None
    for t, opens, _neg_hi, i in bounds:
        if stack and t > prev:
            segments.append((prev, t, spans[stack[-1]][2]))
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        prev = t
    return segments


def reduce_events(events, span_names) -> Trace:
    """A Trace from kineto events: the window runs from the first of the
    harness's spans (names in span_names) to the end of the last; the
    port's spans are the user annotations whose names start with PREFIX."""
    harness, program, device = [], [], []
    launches, host_ops = {}, {}  # correlation id -> start: runtime calls; host ops, ranges
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(ev)
            if kind in _DEVICE_KINDS:
                device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(), kind,
                               ev.correlation_id(), ev.linked_correlation_id()))
            continue
        if _is_launch(ev):
            launches[ev.correlation_id()] = ev.start_ns()
            continue
        host_ops[ev.correlation_id()] = ev.start_ns()
        if ev.is_user_annotation():
            name = ev.name()
            if name in span_names:
                harness.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
            elif name.startswith(PREFIX):
                program.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
    launches.pop(0, None)
    host_ops.pop(0, None)
    if not harness:
        raise RuntimeError("the trace holds none of the harness's spans")
    w_lo = min(s[0] for s in harness)
    w_hi = max(s[1] for s in harness)
    spans = harness + program
    segments = innermost_segments(spans)
    seg_starts = [s[0] for s in segments]

    ops = collections.Counter()
    kernels = collections.Counter()
    launched = collections.Counter()
    unlinked = 0.0
    inside = []
    for lo, hi, name, kind, corr, linked in device:
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi <= lo:
            continue
        s = (hi - lo) * 1e-9
        ops[name] += s
        if kind == "kernel":
            kernels[name] += s
        inside.append((lo, hi))
        t = launches.get(corr, host_ops.get(linked))
        if t is None:
            unlinked += s
            continue
        k = bisect.bisect_right(seg_starts, t) - 1
        launched[segments[k][2] if k >= 0 and t < segments[k][1] else OUTSIDE] += s

    busy = _union(inside)
    gaps, at = [], w_lo
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if at < w_hi:
        gaps.append((at, w_hi))
    idle = collections.Counter()
    j = 0
    for g_lo, g_hi in gaps:
        covered = 0
        while j < len(segments) and segments[j][1] <= g_lo:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < g_hi:
            over = min(g_hi, segments[k][1]) - max(g_lo, segments[k][0])
            if over > 0:
                idle[segments[k][2]] += over * 1e-9
                covered += over
            k += 1
        if g_hi - g_lo - covered > 0:
            idle[OUTSIDE] += (g_hi - g_lo - covered) * 1e-9

    span_s = collections.Counter()
    for lo, hi, name in spans:
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi > lo:
            span_s[name] += (hi - lo) * 1e-9
    return Trace(
        window_s=(w_hi - w_lo) * 1e-9,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-9,
        ops=dict(ops), kernels=dict(kernels), idle_gaps=dict(idle),
        span_s=dict(span_s), span_device_s=dict(launched), unlinked_s=unlinked,
    )
