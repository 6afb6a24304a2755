"""The port's own spans in a traced window, beside the harness's.

The port (kgl_gene_tpu_torch/tracing.py) records a profiler range at each
stage boundary of its forward step, its pair matrix and its product pass,
named kgt.*, while a profiler records. reduce_events here is
trace.reduce_events with those spans read as well:
  - the window is still set by the harness's spans alone;
  - each idle gap is charged to the innermost span that covers it, the
    harness's or the port's; the harness's spans do not nest, so events
    with none of the port's spans give exactly trace.reduce_events's Trace;
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

trace.py does not call it: the benchmark's result line reads none of this
yet. One traced run of a cell with this reduction in place of trace.py's:

    python3 -m port_bench.spans --workload <cell> --seed <n> [--seconds 10]

prints run.py's result line (its breakdown's idle_gaps naming the port's
spans, and `unlinked`, the share of device time with no launch in the
trace) with `spans`: each span's host ms and device ms a call and its idle
seconds in the window.
"""

from __future__ import annotations

from port_bench import run, trace  # first: run.py's set-up clock starts at its import

import argparse
import bisect
import collections
import json
from dataclasses import dataclass, field

import torch

from port_bench.trace import _DEVICE_KINDS, Trace, _kind, _union

__all__ = ["SpanTrace", "innermost_segments", "reduce_events", "run_spans"]

PREFIX = "kgt."
OUTSIDE = "outside_any_span"
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclass
class SpanTrace(Trace):
    span_s: dict = field(default_factory=dict)         # span name -> host seconds
    span_device_s: dict = field(default_factory=dict)  # span name -> device seconds launched
    unlinked_s: float = 0.0                            # device seconds with no launch found

    def breakdown(self, top: int = 10) -> dict:
        out = super().breakdown(top)
        device_s = sum(self.ops.values())
        out["unlinked"] = self.unlinked_s / device_s if device_s > 0 else 0.0
        return out


def _is_launch(ev) -> bool:
    """A runtime or driver call on the host (cudaLaunchKernel,
    cudaMemcpyAsync, cuLaunchKernel, ...): by its activity type where the
    event has one, else by its name (torch 2.11's events have no type)."""
    at = getattr(ev, "activity_type", None)
    if at is not None:
        return str(at() if callable(at) else at) in _LAUNCH_KINDS
    return ev.name().startswith("cu") and not ev.is_user_annotation()


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


def reduce_events(events, span_names) -> SpanTrace:
    """A SpanTrace from kineto events: the window runs from the first of
    the harness's spans (names in span_names) to the end of the last; the
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
    return SpanTrace(
        window_s=(w_hi - w_lo) * 1e-9,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-9,
        ops=dict(ops), kernels=dict(kernels), idle_gaps=dict(idle),
        span_s=dict(span_s), span_device_s=dict(launched), unlinked_s=unlinked,
    )


def run_spans(workload: str, seed: int, seconds: float, device: str = "cuda",
              traffic_override: dict | None = None) -> dict:
    """run.run_cell's traced run of a cell with this reduce_events in place
    of trace.py's, and `spans` added to its result."""
    kept = []

    def reduce(events, span_names):
        kept.append(reduce_events(events, span_names))
        return kept[-1]

    before = trace.reduce_events
    trace.reduce_events = reduce
    try:
        result = run.run_cell(workload, seed, seconds, trace=True, device=device,
                              traffic_override=traffic_override)
    finally:
        trace.reduce_events = before
    t, calls = kept[-1], result["attempted"]
    result["spans"] = {
        "calls": calls,
        "host_ms": {k: v / calls * 1e3 for k, v in sorted(t.span_s.items())},
        "device_ms": {k: v / calls * 1e3 for k, v in sorted(t.span_device_s.items())},
        "idle_s": dict(sorted(t.idle_gaps.items())),
        "unlinked_s": t.unlinked_s,
    }
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one traced run of a cell, the port's spans read")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run_spans(args.workload, args.seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
