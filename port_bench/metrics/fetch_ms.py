"""fetch_ms: host ms a call inside the port's fetch spans (kgt.*.fetch): the
copies of a call's outputs to the host, and the wait for the work before
them."""

from port_bench.metrics._spans import PREFIX, host_ms


def read(ctx):
    return host_ms(ctx, lambda name: name.startswith(PREFIX) and name.endswith(".fetch"))
