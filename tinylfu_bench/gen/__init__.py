"""The benchmark's one traffic generator: a traffic file names a generator
of ``gen/synthetic.py`` and its arguments; ``make`` calls it with the run's
seed."""
from __future__ import annotations

import numpy as np

from . import synthetic


def make(traffic: dict, seed: int) -> np.ndarray:
    """The key trace of ``traffic`` (``{"generator": name, "args": {...}}``)
    for ``seed``, as uint64: (T,) or, for tenant lanes, (B, T)."""
    name = traffic["generator"]
    if name.startswith("_") or not name.endswith("_trace"):
        raise ValueError(f"{name!r} is not a generator of gen/synthetic.py")
    keys = getattr(synthetic, name)(**traffic["args"], seed=int(seed) % 2**64)
    return np.asarray(keys).astype(np.uint64)
