"""select_ms: host ms a call inside kgt.inbreed.select: the AF column read,
the candidate mask and the analysis's select_loci over every variant."""

from port_bench.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, lambda name: name == "kgt.inbreed.select")
