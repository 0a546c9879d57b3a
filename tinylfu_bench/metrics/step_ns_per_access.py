"""Device time of the step kernel in the traced window over all accesses of
all lanes replayed in it, in ns."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.accesses:
        return None
    ks = p.kernels("sketch_step")
    if not ks:
        return None
    return sum(b - a for _, a, b in ks) / ctx.accesses
