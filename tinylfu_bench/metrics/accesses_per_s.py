"""Accesses of every lane, in every whole replay or request of the window,
over the window's time (host clock, the window ends after a sync)."""


def read(ctx):
    if not ctx.units or ctx.window_s <= 0:
        return None
    return ctx.accesses / ctx.window_s
