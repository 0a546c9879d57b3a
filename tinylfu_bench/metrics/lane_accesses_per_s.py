"""Accesses of every lane in every whole replay of the window over the
window's time: the tenant-lane cells' rate, read as ``accesses_per_s``
reads the single stream's."""
from tinylfu_bench.metrics.accesses_per_s import read  # noqa: F401
