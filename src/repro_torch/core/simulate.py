"""Result record of a trace simulation (copy of ``repro/core/simulate.py``'s
``SimResult``, so that the port's results carry the same fields)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SimResult:
    policy: str
    cache_size: int
    trace: str
    accesses: int
    hits: int
    hit_ratio: float
    wall_s: float
    extra: dict = field(default_factory=dict)
