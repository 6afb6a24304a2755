"""hallme_device_ms: device ms a call of the operations launched inside
kgt.inbreed.hallme: every HallME step over every block of loci."""

from port_bench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda name: name == "kgt.inbreed.hallme")
