"""The program's own spans of a traced window: ``repro_torch.analysis.
program_trace`` logs them while ``torch.profiler`` records, on the clock of
the profiler's events, so they are set against the window and the device's
operations as they are.  A program without the span log yields none."""
from __future__ import annotations

from tinylfu_bench.yardstick.profile import idle_gaps, union


def in_window(ctx) -> list | None:
    """The program's spans that lie within the traced window, by start
    (each with ``name``, ``start_ns``, ``end_ns`` and ``counters``), or
    None when the run was not traced or the program logs no spans."""
    p = ctx.profile
    if p is None or p.window[1] <= p.window[0]:
        return None
    from repro_torch.analysis import program_trace
    between = getattr(program_trace, "spans_between", None)
    spans = between(*p.window) if between is not None else []
    return spans or None


def overlap_ns(a: list, b: list) -> int:
    """Time that two sorted lists of disjoint (t0, t1) intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(p, spans: list) -> float | None:
    """Share of the window's device-idle time (``profile.idle_gaps``) that
    falls inside ``spans``, in %; None when the window has no device
    operation or no idle time."""
    if not p.in_window(p.device):
        return None
    gaps = idle_gaps(p)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    w0, w1 = p.window
    inside = union((max(s.start_ns, w0), min(s.end_ns, w1)) for s in spans)
    return 100.0 * overlap_ns(gaps, inside) / idle
