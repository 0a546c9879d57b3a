"""Per replay, the time from the benchmark's span around the engine's entry
to the first step kernel on the card: the trace's copy in, the hashing of
its probes and the state's set-up; the mean over the traced window's
replays, in ms."""
import bisect


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    starts = [a for _, a, _ in p.kernels("sketch_step")]
    gaps = []
    for _, a, b in p.spans_named("replay"):
        i = bisect.bisect_left(starts, a)
        if i < len(starts) and starts[i] <= b:
            gaps.append(starts[i] - a)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
