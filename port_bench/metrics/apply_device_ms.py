"""apply_device_ms: device ms a step of the operations launched inside
kgt.step.apply: the SNP apply, last-valid-wins, both splices, the reverse
complement."""

from port_bench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda name: name == "kgt.step.apply")
