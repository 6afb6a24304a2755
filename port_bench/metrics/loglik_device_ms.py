"""loglik_device_ms: device ms a call of the operations launched inside
kgt.inbreed.loglik: the 65-point grid and the golden-section steps."""

from port_bench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda name: name == "kgt.inbreed.loglik")
