"""The step kernel's share of its roofline: the least time of the window's
launches (yardstick/roofline.py: the bytes their accesses address, each
distinct word of a launch once, over 3.35 TB/s, or their operations over
67 T/s, the larger) over the step kernels' device time."""


def read(ctx):
    p = ctx.profile
    least = ctx.least_s("sketch_step")
    if p is None or least is None:
        return None
    ks = p.kernels("sketch_step")
    if not ks:
        return None
    return 100.0 * least / (sum(b - a for _, a, b in ks) / 1e9)
