"""What the span readers share: a span's host or device ms a call, from the
traced window's span_s and span_device_s (trace.py). A span the window
does not hold leaves its metric out; one that launched nothing on the
device reads 0 device ms."""

from __future__ import annotations

from port_bench.trace import PREFIX

__all__ = ["PREFIX", "device_ms", "host_ms"]


def _named(ctx, match):
    return [name for name in (ctx.trace.span_s if ctx.trace else ()) if match(name)]


def host_ms(ctx, match):
    """Host ms a call inside the spans whose name match() accepts; None
    where the window holds none of them."""
    names = _named(ctx, match)
    return sum(ctx.trace.span_s[n] for n in names) / ctx.calls * 1e3 if names else None


def device_ms(ctx, match):
    """Device ms a call of the operations launched inside the spans whose
    name match() accepts (the innermost span that holds each launch); None
    where the window holds none of them."""
    names = _named(ctx, match)
    if not names:
        return None
    return sum(ctx.trace.span_device_s.get(n, 0.0) for n in names) / ctx.calls * 1e3
