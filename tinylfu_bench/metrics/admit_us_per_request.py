"""Device time of the admission kernel over the traced window's requests,
in microseconds a request."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.units:
        return None
    ks = p.kernels("admission")
    if not ks:
        return None
    return sum(b - a for _, a, b in ks) / len(ctx.units) / 1e3
