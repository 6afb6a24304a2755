"""body_device_ms: device ms a step of every kernel but the distance kernel:
SNP apply, last-valid-wins, splice, strand, B2, validity, counts."""

from port_bench.metrics._shared import kernel_ms_per_call


def read(ctx):
    return kernel_ms_per_call(ctx, lambda name: "myers" not in name
                              and "bitvector_kernel" not in name)
