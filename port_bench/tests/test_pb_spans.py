"""trace.reduce_events on synthetic kineto events and on the events of
traced CPU runs: window_s, busy_s, ops and kernels equal the reduction
before the port's spans were read (reduce_before, kept here frozen), so
every per-layer metric of before reads the same; the harness's spans
alone give the same idle too; nested port spans take the idle under them;
a device op goes to the span that holds its launch, and the spans' device
seconds and the unlinked ones sum to the window's device seconds. And one
traced CPU run of each cell names the port's spans."""

import collections
import json
from dataclasses import dataclass

import pytest
import torch

from port_bench import run, spans, trace
from port_bench.tests.cells import hooks_of_cell, with_hooks

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
HARNESS = {"step.call", "step.fetch", "bench.record"}


@dataclass
class Ev:
    """The kineto event methods the reductions call."""
    _name: str
    lo: int
    hi: int
    kind: str            # activity type
    corr: int = 0
    linked: int = 0

    def name(self):
        return self._name

    def start_ns(self):
        return self.lo

    def duration_ns(self):
        return self.hi - self.lo

    def device_type(self):
        return CUDA if self.kind in ("kernel", "gpu_memcpy", "gpu_memset",
                                     "gpu_user_annotation") else CPU

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def activity_type(self):
        return self.kind

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def span(name, lo, hi):
    return Ev(name, lo, hi, "user_annotation")


def kernel(name, lo, hi, corr=0):
    return Ev(name, lo, hi, "kernel", corr=corr, linked=corr)


def launch(lo, corr):
    return Ev("cudaLaunchKernel", lo, lo + 2, "cuda_runtime", corr=corr)


def reduce_before(events, span_names) -> dict:
    """The reduction before the port's spans were read (trace.py as the
    benchmark first had it), frozen: window, busy, ops, kernels, and the
    idle gaps charged to the harness's spans alone."""
    spans_, device = [], []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = trace._kind(ev)
            if kind in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(), kind))
        elif ev.name() in span_names and ev.is_user_annotation():
            spans_.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    w_lo = min(s[0] for s in spans_)
    w_hi = max(s[1] for s in spans_)
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
    busy = trace._union(inside)
    gaps, at = [], w_lo
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if at < w_hi:
        gaps.append((at, w_hi))
    idle = collections.Counter()
    spans_.sort()
    j = 0
    for g_lo, g_hi in gaps:
        covered = 0
        while j < len(spans_) and spans_[j][1] <= g_lo:
            j += 1
        k = j
        while k < len(spans_) and spans_[k][0] < g_hi:
            over = min(g_hi, spans_[k][1]) - max(g_lo, spans_[k][0])
            if over > 0:
                idle[spans_[k][2]] += over * 1e-9
                covered += over
            k += 1
        if g_hi - g_lo - covered > 0:
            idle["outside_any_span"] += (g_hi - g_lo - covered) * 1e-9
    return {"window_s": (w_hi - w_lo) * 1e-9, "busy_s": sum(hi - lo for lo, hi in busy) * 1e-9,
            "ops": dict(ops), "kernels": dict(kernels), "idle_gaps": dict(idle)}


def assert_keeps_the_readings(new, old):
    """Window, busy, ops and kernels as before; every device second either
    under a span or unlinked."""
    for name in ("window_s", "busy_s", "ops", "kernels"):
        assert getattr(new, name) == old[name], name
    assert sum(new.span_device_s.values()) + new.unlinked_s == pytest.approx(
        sum(new.ops.values()), rel=1e-12, abs=1e-15)


def harness_only():
    """Two calls with their fetch and check; kernels, a copy, a set and a
    device annotation, some past the window's edges; one gap over spans
    of two calls, so a name takes two pieces of it."""
    return [
        span("step.call", 100, 400), span("step.fetch", 400, 450), span("bench.record", 460, 500),
        span("step.call", 500, 900), span("step.fetch", 900, 980), span("bench.record", 990, 1200),
        span("other", 0, 2000),
        kernel("myers", 50, 150, 1), kernel("add", 200, 260), kernel("add", 240, 300),
        Ev("Memcpy HtoD", 405, 420, "gpu_memcpy"), Ev("Memset", 120, 130, "gpu_memset"),
        Ev("kgt.step", 100, 400, "gpu_user_annotation"), kernel("tail", 1150, 1300),
        launch(120, 1),
    ]


def test_with_the_harness_spans_alone_the_trace_is_trace_py_s():
    events = harness_only()
    old = reduce_before(events, HARNESS)
    new = trace.reduce_events(events, HARNESS)
    assert_keeps_the_readings(new, old)
    assert new.idle_gaps == old["idle_gaps"]
    assert old["idle_gaps"]["bench.record"] > 0 and old["idle_gaps"]["step.call"] > 0
    # every op but myers has no launch in the trace: add 60 + 60, copy 15, set 10, tail 50
    assert new.unlinked_s == pytest.approx(195e-9)


def test_idle_goes_to_the_innermost_span_and_sums_to_the_idle_window():
    events = [
        span("step.call", 0, 1000), span("kgt.step", 10, 990),
        span("kgt.step.upload", 10, 100), span("kgt.step.apply", 100, 400),
        span("kgt.step.translate", 400, 500), span("kgt.step.checks", 500, 990),
        span("step.fetch", 1000, 1200), span("bench.record", 1300, 1400),
        kernel("apply", 150, 250, 7), launch(120, 7),
        kernel("checks", 600, 1100, 8), launch(520, 8),
    ]
    t = trace.reduce_events(events, HARNESS)
    assert t.window_s == pytest.approx(1400e-9) and t.busy_s == pytest.approx(600e-9)
    want = {"step.call": 10, "kgt.step.upload": 90, "kgt.step.apply": 50 + 150,
            "kgt.step.translate": 100, "kgt.step.checks": 100, "step.fetch": 100,
            "outside_any_span": 100, "bench.record": 100}
    assert t.idle_gaps == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(t.idle_gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.span_s["kgt.step"] == pytest.approx(980e-9)
    assert t.span_s["kgt.step.checks"] == pytest.approx(490e-9)
    assert "kgt.step" not in t.idle_gaps  # its children cover all of it
    assert_keeps_the_readings(t, reduce_before(events, HARNESS))


def test_a_device_op_goes_to_the_span_that_holds_its_launch():
    events = [
        span("matrix.call", 0, 1000), span("kgt.pairs", 5, 995),
        span("kgt.pairs.upload", 10, 50), span("kgt.pairs.gather", 50, 60),
        span("kgt.pairs.distance", 60, 70), span("kgt.pairs.fetch", 70, 990),
        span("bench.record", 1000, 1100),
        Ev("Memcpy HtoD", 30, 80, "gpu_memcpy", corr=1, linked=1), launch(20, 1),
        kernel("gather", 80, 120, 2), launch(55, 2),
        kernel("myers", 120, 500, 3), launch(65, 3),
        # linked by its own correlation id where the link is not set
        Ev("Memcpy DtoH", 500, 520, "gpu_memcpy", corr=4), launch(80, 4),
        kernel("stray", 600, 650, 99),  # its launch is not in the trace
        kernel("late", 700, 710, 5), launch(1200, 5),  # launched outside every span
        # no runtime call of its own: the host op its link names stands in ...
        Ev("add", 720, 730, "kernel", corr=50, linked=60),
        Ev("aten::add", 75, 78, "cpu_op", corr=60),
        # ... and a link is never read as a runtime call's id (another count)
        Ev("sum", 740, 745, "kernel", corr=51, linked=2),
    ]
    t = trace.reduce_events(events, {"matrix.call", "bench.record"})
    want = {"kgt.pairs.upload": 50, "kgt.pairs.gather": 40, "kgt.pairs.distance": 380,
            "kgt.pairs.fetch": 20 + 10, "outside_any_span": 10}
    assert t.span_device_s == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert t.unlinked_s == pytest.approx(55e-9)
    assert t.unlinked_share() == pytest.approx(55 / 565)
    assert_keeps_the_readings(t, reduce_before(events, {"matrix.call", "bench.record"}))
    assert t.idle_gaps["kgt.pairs.fetch"] == pytest.approx((80 + 50 + 10 + 10 + 245) * 1e-9)


def test_innermost_segments_take_the_shorter_of_two_spans_opened_at_once():
    segs = trace.innermost_segments([(0, 10, "a"), (0, 4, "b"), (6, 10, "c"), (20, 30, "d")])
    assert segs == [(0, 4, "b"), (4, 6, "a"), (6, 10, "c"), (20, 30, "d")]


@pytest.mark.parametrize("workload", with_hooks(MANIFEST))
def test_the_reduction_keeps_the_old_readings_on_a_traced_cpu_run(workload, monkeypatch):
    reduce = trace.reduce_events
    compared = []

    def both(events, span_names):
        new = reduce(events, span_names)
        assert_keeps_the_readings(new, reduce_before(events, span_names))
        compared.append(new)
        return new

    monkeypatch.setattr(trace, "reduce_events", both)
    cells = hooks_of_cell(MANIFEST, workload)
    result = run.run_cell(workload, 3, 0.05, trace=True, device="cpu",
                          traffic_override=cells.SMALL)
    assert result["correct"] and len(compared) == 1
    assert set(compared[0].span_s) >= set(run.load_module(
        "drivers", run.cell_files(MANIFEST, workload)[1]["driver"]).SPANS)


@pytest.mark.parametrize("workload", with_hooks(MANIFEST))
def test_a_traced_cpu_run_names_the_port_s_spans(workload):
    cells = hooks_of_cell(MANIFEST, workload)
    traffic = run.cell_files(MANIFEST, workload)[2]
    result = spans.run_spans(workload, 3, 0.05, device="cpu", traffic_override=cells.SMALL)
    assert result["correct"]
    host = result["spans"]["host_ms"]
    idle = dict(result["breakdown"]["idle_gaps"])
    stages = cells.port_spans(traffic)
    assert set(stages) <= set(host) and all(host[s] > 0 for s in stages)
    if stages:
        assert any(name.startswith("kgt.") for name in idle)
    assert result["unlinked"] == 0.0  # no device ops on the CPU
