"""gather_device_ms: device ms a matrix of the gathers of the pairs' rows and
lengths (index_select: gather kernels in PyTorch's CUDA build)."""

from port_bench.metrics._shared import kernel_ms_per_call


def read(ctx):
    return kernel_ms_per_call(ctx, lambda name: "gather" in name.lower()
                              or "index" in name.lower())
