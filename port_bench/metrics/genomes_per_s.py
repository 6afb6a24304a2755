"""genomes_per_s: every genome whose outputs reached the host in the window,
over the window's seconds."""


def read(ctx):
    return ctx.units / ctx.window_s
