"""upload_ms: host ms a call inside the port's upload spans (kgt.*.upload):
the step's three torch.as_tensor of its inputs; the matrix's pool,
lengths and pair indices."""

from port_bench.metrics._spans import PREFIX, host_ms


def read(ctx):
    return host_ms(ctx, lambda name: name.startswith(PREFIX) and name.endswith(".upload"))
