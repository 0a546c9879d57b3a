"""Peak device memory allocated in the window (the allocator's peak, reset
at the window's start), in GiB."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
