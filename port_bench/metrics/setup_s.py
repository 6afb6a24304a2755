"""setup_s: seconds from the harness's start to the first timed call."""


def read(ctx):
    return ctx.setup_s
