"""Keys recorded in every request of the window over the window's time:
the admission cells' rate, read as ``accesses_per_s`` reads its own."""
from tinylfu_bench.metrics.accesses_per_s import read  # noqa: F401
