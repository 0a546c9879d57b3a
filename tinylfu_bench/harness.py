"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the comparison that decides ``correct``, the metrics and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json`` (whose ``system`` names the
driver ``drivers/<system>.py``), ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` (a function ``read(ctx)`` returning the value, or
None when it finds nothing to read; ``<metric>.<cell kind>`` may share the
reader of ``<metric>``).
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload named ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list[dict]:
    """The end-to-end metrics of the cell (untraced run) or its per-layer
    metrics (traced run): those whose ``workloads`` name the cell, and the
    end-to-end metrics without ``workloads``."""
    part = bench["per_layer" if traced else "end_to_end"]
    return [m for m in part
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    """The reader module ``metrics/<name>.py``; a metric ``<base>.<cell
    kind>`` without a file of its own is read by ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"tinylfu_bench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(system: str):
    return importlib.import_module(f"tinylfu_bench.drivers.{system}")


def forbidden_loaded(modules=None) -> list[str]:
    """Of ``modules`` (default: the loaded ones) the top-level names that
    are JAX's or the JAX package's, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


@dataclass
class Context:
    """What a metric reader reads."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    memory_peak_bytes: int
    units: list                 # (t0, t1, accesses) per unit, host clock
    profile: object = None      # yardstick.profile.Profile of a traced run
    work: list = field(default_factory=list)   # least seconds by kernel

    @property
    def accesses(self) -> int:
        return sum(u[2] for u in self.units)

    def least_s(self, kind: str) -> float | None:
        vals = [w[kind] for w in self.work if kind in w]
        return sum(vals) if vals else None


@contextlib.contextmanager
def one_core():
    """Keep the calling thread on one core (the last it may use) while the
    window runs, and give it back all of them afterwards: threads started
    later, such as the reference's workers, inherit the whole set."""
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def _span_factory(traced: bool):
    if not traced:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def run_cell(cell: dict, config: dict, traffic: dict, metrics: list,
             seed: int, seconds: float, traced: bool, device, t_start: float,
             log=sys.stderr, program=None) -> dict:
    """Set up, measure, check; returns the result (not yet printed).
    ``program`` stands in the place of the driver's entry into the program
    under test (``control.py``'s broken reference)."""
    import torch
    on_card = torch.device(device).type == "cuda"
    drv = driver(config["system"])
    session = drv.Session(config, traffic, seed, device, program=program)
    session.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    span = _span_factory(traced)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    units = []
    w0 = time.perf_counter()
    with one_core(), span("window"):
        while True:
            units.append(session.unit(span))
            if time.perf_counter() - w0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    profile_data = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from tinylfu_bench.yardstick import profile as yprof
        profile_data = yprof.read(prof, drv.SPANS)
        del prof
    print(f"window {window_s:.3f} s, {len(units)} units, set-up "
          f"{setup_s:.3f} s", file=log)
    t_ref = time.perf_counter()
    checks = session.check(traced)
    print(f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
          file=log)
    ctx = Context(cell, config, traffic, setup_s, window_s, peak, units,
                  profile_data, [session.unit_work(i)
                                 for i in range(len(units))])
    values = {}
    for m in metrics:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(units),
              "failed": session.failed(len(units)),
              "metrics": values, "device": dev}
    if profile_data is not None:
        from tinylfu_bench.yardstick import profile as yprof
        dev["busy_s"] = yprof.busy_ns(profile_data) / 1e9
        dev["window_s"] = profile_data.window_s
        result["breakdown"] = yprof.breakdown(profile_data)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(workload: str, seed: int, seconds: float, trace: int,
         t_start: float) -> int:
    import torch
    import repro_torch  # noqa: F401  (the program under test, from src/)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = load_cell(bench, workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, config, traffic,
                      cell_metrics(bench, cell, bool(trace)), seed, seconds,
                      bool(trace), "cuda", t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
