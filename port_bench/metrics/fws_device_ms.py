"""fws_device_ms: device ms a call of the operations launched inside
kgt.fws.variants and kgt.fws.genomes: both passes over the codes, AF, hs,
bins and segments, and the per-genome sums."""

from port_bench.metrics._fws import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx)
