"""Per engine run, the program's ``engine.lanes`` span: the trace's uint64
keys split into their (lo, hi) int32 lanes on the host; the mean over the
traced window's runs, in ms."""
from tinylfu_bench.yardstick import spans as sp


def read(ctx):
    spans = sp.in_window(ctx)
    lanes = [s for s in spans or [] if s.name == "engine.lanes"]
    if not lanes:
        return None
    return sum(s.end_ns - s.start_ns for s in lanes) / len(lanes) / 1e6
