"""program_idle_pct: the share of the traced window's idle time (no
kernel, copy or set on the card) charged to the port's spans (kgt.*,
each gap to the innermost span over it), the rest being the harness's or
outside any span. None where the window has no idle time or holds none of
the port's spans."""

from port_bench.metrics._spans import PREFIX


def read(ctx):
    t = ctx.trace
    idle = t.window_s - t.busy_s if t else 0.0
    if idle <= 0 or not any(name.startswith(PREFIX) for name in t.span_s):
        return None
    return 100.0 * sum(s for name, s in t.idle_gaps.items() if name.startswith(PREFIX)) / idle
