"""index_ms: host ms a matrix inside kgt.pairs.index: the upper triangle's
indices and the rank's rows of them."""

from port_bench.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, lambda name: name == "kgt.pairs.index")
