"""body_host_ms: host ms a step inside the step body's spans
(kgt.step.apply, .translate, .distance, .checks): the enqueue of the body's
kernels and whatever waits among them."""

from port_bench.metrics._spans import host_ms

BODY = {"kgt.step.apply", "kgt.step.translate", "kgt.step.distance", "kgt.step.checks"}


def read(ctx):
    return host_ms(ctx, BODY.__contains__)
