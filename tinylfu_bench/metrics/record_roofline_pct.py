"""The record kernels' share of their roofline: the least time of the
window's adds and resets (yardstick/roofline.py: the key lanes and each
distinct sketch word a batch addresses over 3.35 TB/s; a reset's whole
sketch read and written) over their device time."""


def read(ctx):
    p = ctx.profile
    least = ctx.least_s("record")
    if p is None or least is None:
        return None
    ks = p.kernels("sketch_update") + p.kernels("sketch_reset")
    if not ks:
        return None
    return 100.0 * least / (sum(b - a for _, a, b in ks) / 1e9)
