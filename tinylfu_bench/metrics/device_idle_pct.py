"""Share of the traced window in which no operation (kernel or copy) ran on
the card, from the profiler's device intervals."""
from tinylfu_bench.yardstick.profile import busy_ns


def read(ctx):
    p = ctx.profile
    if p is None or not p.in_window(p.device) or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_ns(p) / 1e9 / p.window_s)
