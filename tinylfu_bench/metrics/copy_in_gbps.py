"""The rate of the engine's copy of the key lanes onto the card: the
program's ``bytes_in`` counted inside its ``engine.copy_in`` spans over
their time, summed over the traced window's runs, in GB/s."""
from tinylfu_bench.yardstick import spans as sp


def read(ctx):
    spans = sp.in_window(ctx)
    copies = [s for s in spans or [] if s.name == "engine.copy_in"]
    ns = sum(s.end_ns - s.start_ns for s in copies)
    nbytes = sum(s.counters.get("bytes_in", 0) for s in copies)
    if ns <= 0 or nbytes <= 0:
        return None
    return nbytes / ns
