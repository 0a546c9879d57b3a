"""Seconds from the start of run.py to the window's start: imports, the
card's context, the trace from the seed, the kernels' build (found in the
checkout's build/ after the first run) and the warm-up."""


def read(ctx):
    return ctx.setup_s
