"""pairs_per_s: every pair of every matrix that reached the host in the
window, over the window's seconds."""


def read(ctx):
    return ctx.units / ctx.window_s
