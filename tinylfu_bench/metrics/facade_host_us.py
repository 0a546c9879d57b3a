"""Per request, its wall time minus the device time of the kernels that
ran inside it: what the facade spends on the host (splitting keys into
lanes, the copies, waiting for and reading the verdicts); the mean over the
traced window's requests, in microseconds."""
import bisect


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ks = [k for k in p.in_window(p.device) if "emcpy" not in k[0]
          and "emset" not in k[0]]
    if not ks:
        return None
    starts = [a for _, a, _ in ks]
    host = []
    for _, a, b in p.spans_named("request"):
        i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        host.append((b - a) - sum(k[2] - k[1] for k in ks[i:j]))
    return sum(host) / len(host) / 1e3 if host else None
