"""host_ms: mean ms from the step's call to its return, before the fetch:
the upload and the Python enqueue."""


def read(ctx):
    return sum(ctx.host_s) / len(ctx.host_s) * 1e3
