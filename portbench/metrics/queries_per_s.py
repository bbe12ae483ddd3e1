"""Queries whose invocation completed in the window, over the whole time
those invocations took (host clock)."""


def read(ctx):
    return ctx.units / ctx.window_s
