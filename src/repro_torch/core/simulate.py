"""Trace-driven cache simulation harness (host side).

Drives any object exposing ``access(key) -> bool`` over an integer-key trace
and reports hit ratios: the engine behind the paper's figures.  Copy of
``repro/core/simulate.py`` (plain Python and numpy), held equal to it by
``tests/test_torch_host_engine.py``; ``SimResult`` is the record the device
engine (``core.device_simulate``) returns too, and ``save_results`` writes
JSON that either package's ``load_results`` reads.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, asdict
from typing import Callable, Iterable

import numpy as np


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


def run_trace(cache, trace: np.ndarray, warmup: int = 0,
              trace_name: str = "?") -> SimResult:
    """Simulate; ``warmup`` initial accesses update state but don't count.

    ``trace_name`` labels the result so single-trace callers don't produce
    ``trace="?"`` rows (run_matrix overwrites it with its own key).
    """
    t0 = time.perf_counter()
    access = cache.access
    hits = 0
    n = len(trace)
    keys = trace.tolist()                 # python ints: ~2x faster inner loop
    for i in range(warmup):
        access(keys[i])
    counted = n - warmup
    for i in range(warmup, n):
        if access(keys[i]):
            hits += 1
    wall = time.perf_counter() - t0
    name = getattr(cache, "name", type(cache).__name__)
    if hasattr(cache, "ev"):              # Cache driver: name from parts
        adm = "tinylfu+" if cache.admission is not None else ""
        name = adm + cache.ev.name
    return SimResult(policy=name, cache_size=cache.capacity, trace=trace_name,
                     accesses=counted, hits=hits,
                     hit_ratio=hits / max(1, counted), wall_s=wall)


def run_matrix(policy_factories: dict[str, Callable[[int], object]],
               traces: dict[str, np.ndarray],
               cache_sizes: Iterable[int],
               warmup_frac: float = 0.0,
               verbose: bool = True) -> list[SimResult]:
    """Cartesian sweep: policies × traces × sizes."""
    results = []
    for tname, tr in traces.items():
        warm = int(len(tr) * warmup_frac)
        for size in cache_sizes:
            for pname, factory in policy_factories.items():
                cache = factory(size)
                r = run_trace(cache, tr, warmup=warm)
                r.policy = pname
                r.trace = tname
                results.append(r)
                if verbose:
                    print(f"  {tname:>14s} C={size:<7d} {pname:<16s} "
                          f"hit={r.hit_ratio:.4f}  ({r.wall_s:.1f}s)",
                          flush=True)
    return results


def save_results(results: list[SimResult], path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump([asdict(r) for r in results], f, indent=1)


def load_results(path: str) -> list[SimResult]:
    with open(path) as f:
        return [SimResult(**d) for d in json.load(f)]


def theoretical_max_hit_ratio(probs: np.ndarray, length: int | None = None) -> float:
    """Paper §5.2: for a static distribution the best possible hit ratio is
    bounded by sum(max(0, f_i - 1)) / sum(f_i) over expected counts f_i = p_i*N
    (the first access to each item is always a miss)."""
    n = length if length is not None else int(round(1.0 / probs.min()))
    counts = probs * n
    return float(np.maximum(0.0, counts - 1.0).sum() / counts.sum())
