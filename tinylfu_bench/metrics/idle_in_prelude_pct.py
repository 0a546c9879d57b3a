"""Share of the traced window's device-idle time that falls inside the
engine's prelude, the program's ``engine.lanes``, ``engine.copy_in``,
``engine.state`` and ``engine.probes`` spans, in %."""
from tinylfu_bench.yardstick import spans as sp

PRELUDE = ("engine.lanes", "engine.copy_in", "engine.state", "engine.probes")


def read(ctx):
    spans = sp.in_window(ctx)
    prelude = [s for s in spans or [] if s.name in PRELUDE]
    if not prelude:
        return None
    return sp.idle_share_in(ctx.profile, prelude)
