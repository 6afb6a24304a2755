"""assemble_ms: host ms a matrix inside kgt.pairs.assemble: the distances'
cast, the band check and the symmetric float64 fill."""

from port_bench.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, lambda name: name == "kgt.pairs.assemble")
