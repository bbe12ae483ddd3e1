"""Exhaustive query-locus pairs completed in the window, over the whole
time they took (host clock)."""


def read(ctx):
    return ctx.units / ctx.window_s
