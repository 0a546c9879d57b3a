"""The control of a cell's comparison: the reference put in the program's
place with one of the configuration's guarantees broken, run through the
harness at the cell's own size as a run of the program is, with a window
of one unit.  Its run has to come out not correct, or the comparison could
not tell a broken program from a sound one.

    python3 tinylfu_bench/control.py --workload <name> --seed <n> [...]

The replay cells' control drops the last access of every chunk of the
traffic ("no access is dropped"); the admission cells' counts recorded keys
with a plain increment of every row instead of the conservative update.
Prints each seed's numbers compared beside their limits and exits 1 if the
control comes out correct on some seed.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class ReplayControl:
    """In ``simulate_trace``'s place: the reference over every lane, the
    last access of every chunk dropped.  A replay of the same trace is the
    same replay, so it is computed once."""

    def __init__(self):
        self.memo = None

    def __call__(self, trace, capacity, *, warmup, chunk, device,
                 return_state, streams=1, **geo_kw):
        import torch
        from tinylfu_bench.drivers import replay
        if self.memo is None or self.memo[0] is not trace:
            out = replay.reference_lanes(dict(geo_kw, capacity=capacity),
                                         trace, warmup, chunk, False,
                                         drop_every=chunk)
            hits = np.stack([h for (h, _), _ in out])
            state = {k: np.stack([st[k] for (_, st), _ in out])
                     for k in out[0][0][1]}
            if trace.ndim == 1:
                hits, state = hits[0], {k: v[0] for k, v in state.items()}
            self.memo = (trace, torch.from_numpy(hits).to(device),
                         {k: torch.from_numpy(v).to(device)
                          for k, v in state.items()})
        return None, self.memo[2], self.memo[1]


class AdmissionControl:
    """In ``DeviceTinyLFU``'s place: the reference filter counting every
    row below the cap."""

    def __init__(self, num_blocks: int, sample_factor: int = 8,
                 device=None):
        from tinylfu_bench.reference.tinylfu import TinyLFU
        self.ref = TinyLFU(num_blocks, sample_factor=sample_factor,
                           conservative=False)

    def record(self, keys) -> None:
        self.ref.record(keys)

    def admit(self, cands, victims):
        return self.ref.admit(cands, victims)

    @property
    def state(self) -> dict:
        import torch
        return {k: torch.from_numpy(np.asarray(v))
                for k, v in self.ref.state().items()}


# a fresh program of each system's control: the replay's callable, the
# admission's filter class
CONTROLS = {"replay": ReplayControl, "admission": lambda: AdmissionControl}


def control_run(cell: dict, config: dict, traffic: dict, seed: int,
                device, log=sys.stderr, bench: dict | None = None) -> dict:
    """The harness's run of the cell (of ``bench``, default
    BENCHMARK.json) with the control as the program."""
    from tinylfu_bench import harness
    bench = bench or harness.load_json(ROOT / "BENCHMARK.json")
    return harness.run_cell(cell, config, traffic,
                            harness.cell_metrics(bench, cell, False),
                            seed, 0, False, device, time.perf_counter(),
                            log=log, program=CONTROLS[config["system"]]())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from tinylfu_bench import harness
    cell, config, traffic = harness.load_cell(
        harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ok = True
    for seed in args.seed:
        r = control_run(cell, config, traffic, seed, device)
        ok &= r["correct"] is False
        checks = " ".join(f"{k} {c['value']} limit {c['limit']}"
                          for k, c in r["checks"].items())
        print(f"control {args.workload} seed {seed} correct {r['correct']} "
              f"{checks}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
