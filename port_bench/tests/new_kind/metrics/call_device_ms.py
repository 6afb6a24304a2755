"""call_device_ms: device ms a call of the operations launched inside the
harness's span rows.call."""

from port_bench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda name: name == "rows.call")
