"""Small configurations and traffic of the benchmark's two drivers, for the
CPU tests: the cells' shapes (8-way sets, 4 rows, a 3-probe doorkeeper,
tenant lanes, batched requests) at sizes the plain versions run in
seconds."""
import numpy as np

REPLAY = {"system": "replay",
          "program": {"capacity": 64, "assoc": 8, "window_frac": 0.05,
                      "sample_factor": 8, "rows": 4, "counter_bits": 4,
                      "doorkeeper": True}}
ADMISSION = {"system": "admission",
             "program": {"num_blocks": 64, "sample_factor": 8}}
SINGLE = {"generator": "zipf_trace",
          "args": {"length": 900, "n_items": 300, "alpha": 0.9},
          "warmup": 100, "chunk": 128}
LANES = {"generator": "tenant_lanes_trace",
         "args": {"streams": 8, "length": 160, "n_items": 300, "alpha": 0.9,
                  "tenant_alpha": 1.0},
         "warmup": 100, "chunk": 128}
BATCHES = {"generator": "zipf_trace",
           "args": {"length": 2000, "n_items": 400, "alpha": 0.9},
           "batch": 256}
CASES = {"zipf09-single": (REPLAY, SINGLE),
         "zipf09-tenants64": (REPLAY, LANES),
         "admit-zipf09-b16384": (ADMISSION, BATCHES)}
SEED = 2**31 + 12_345


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of the cells under ``pending/``, which
    BENCHMARK.json leaves out but the harness runs all the same."""
    from tinylfu_bench import harness
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for path in sorted((harness.HERE / "pending").glob("*.json")):
        for k, entries in harness.load_json(path).items():
            if k != "why":
                out[k] += entries
    return out


def bench_all() -> dict:
    from tinylfu_bench import harness
    return with_pending(harness.load_json(harness.ROOT / "BENCHMARK.json"))


def run_small(workload: str, traced: bool = False, seconds: float = 0.5,
              seed: int = SEED, traffic: dict | None = None) -> dict:
    """One run of ``workload``'s cell at its small size on the CPU
    (``traffic`` in place of the small case's)."""
    import time
    from tinylfu_bench import harness
    bench = bench_all()
    cell, _, _ = harness.load_cell(bench, workload)
    config, small = CASES[workload]
    return harness.run_cell(cell, config, traffic or small,
                            harness.cell_metrics(bench, cell, traced), seed,
                            seconds, traced, "cpu", time.perf_counter())


def control_small(workload: str, traffic: dict | None = None,
                  seed: int = SEED) -> dict:
    """The control's run of ``workload``'s cell at its small size on the
    CPU."""
    from tinylfu_bench import control, harness
    bench = bench_all()
    cell, _, _ = harness.load_cell(bench, workload)
    config, small = CASES[workload]
    return control.control_run(cell, config, traffic or small, seed, "cpu",
                               bench=bench)


def zipf_keys(n: int, n_items: int, seed: int) -> np.ndarray:
    from tinylfu_bench.gen import synthetic
    return synthetic.zipf_trace(n, n_items=n_items, alpha=0.9,
                                seed=seed).astype(np.uint64)
