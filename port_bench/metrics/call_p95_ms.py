"""call_p95_ms: 95th percentile over every call of the window, from the call
to its outputs on the host."""

from port_bench.yardstick import p95


def read(ctx):
    return p95(ctx.latencies_s) * 1e3
