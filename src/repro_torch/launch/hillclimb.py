"""Window-adaptation driver: run the hill-climbed W-TinyLFU engine against a
trace, optionally next to the static-window sweep it must beat, and record
the per-epoch (quota, hits) trajectory.

Counterpart of the reference's ``repro/launch/hillclimb.py``: the same
traces, flags, printed lines and JSON rows.  The adaptive run is one
``simulate_trace(..., adaptive=True)`` (the step kernel's adaptive
instances, with the climb and ``rebalance`` between epochs on the card);
``--static-sweep`` adds ``simulate_sweep(..., mode="sequential")`` over
``STATIC_WFS``.  Everything runs on the card unless ``--device cpu`` asks
for the plain versions on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --trace phase \\
      --capacity 1000 --length 200000 --assoc 8 --static-sweep

Trajectory JSON lands in
``experiments/adaptive_torch/<trace>_C<capacity>.json`` (not
``experiments/adaptive/``, which holds the reference's committed runs) and
feeds ``python -m repro_torch.analysis.report --what adaptive``.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import asdict

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../..",
                       "experiments", "adaptive_torch")

STATIC_WFS = (0.01, 0.05, 0.10, 0.20, 0.40)


def make_trace(name: str, length: int, seed: int) -> np.ndarray:
    from repro_torch import traces as T
    gens = {
        "zipf": lambda: T.zipf_trace(length, n_items=max(1000, length // 4),
                                     alpha=0.9, seed=seed),
        "fickle": lambda: T.fickle_churn_trace(length, seed=seed),
        "phase": lambda: T.phase_shift_trace(length, seed=seed),
        "youtube": lambda: T.youtube_dynamic_trace(length, seed=seed),
        "wiki": lambda: T.wiki_drift_trace(length, seed=seed),
        "oltp": lambda: T.oltp_like_trace(length, seed=seed),
        "spc1": lambda: T.spc1_like_trace(length, seed=seed),
        "glimpse": lambda: T.glimpse_trace(length, seed=seed),
    }
    if name not in gens:
        raise SystemExit(f"unknown trace {name!r}; one of {sorted(gens)}")
    return gens[name]()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="phase",
                    help="zipf|fickle|phase|youtube|wiki|oltp|spc1|glimpse")
    ap.add_argument("--capacity", type=int, default=1000)
    ap.add_argument("--length", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--assoc", type=int, default=8,
                    help="ways per set; 0 = exact flat tables")
    ap.add_argument("--epoch-len", type=int, default=4096)
    ap.add_argument("--window-frac", type=float, default=0.01,
                    help="initial window quota")
    ap.add_argument("--static-sweep", action="store_true",
                    help="also run the static windows the climber must beat")
    ap.add_argument("--out", default=None, help="output JSON path")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card, no fallback) or cpu "
                         "(the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the CLI with ``argv`` (default: the command line); returns the
    rows it wrote."""
    args = parse_args(argv)

    from repro_torch.core.device_simulate import (simulate_trace,
                                                  simulate_sweep, ClimbSpec)
    from repro_torch.kernels.sketch_common import resolve_device

    device = resolve_device(args.device)
    tr = make_trace(args.trace, args.length, args.seed)
    assoc = args.assoc or None
    climb = ClimbSpec(epoch_len=args.epoch_len)
    rows = []

    a = simulate_trace(tr, args.capacity, adaptive=True, assoc=assoc,
                       window_frac=args.window_frac, climb=climb,
                       trace_name=args.trace, device=device)
    print(f"adaptive: hit {a.hit_ratio:.4f}  final quota "
          f"{a.extra['final_quota']} "
          f"({a.extra['final_quota'] / args.capacity:.1%} of C)", flush=True)
    tj = a.extra.get("trajectory")
    if tj is None:
        print(f"  (trace shorter than one epoch of {args.epoch_len} — "
              "no climb ran; lower --epoch-len)", flush=True)
    else:
        E = tj["epoch_len"]
        print("  epoch  quota  hit-rate")
        for i, (q, e) in enumerate(zip(tj["quota"], tj["epoch_hits"])):
            print(f"  {i:5d}  {q:5d}  {e / E:.3f}")
    rows.append(asdict(a))

    if args.static_sweep:
        stat = simulate_sweep(tr, [args.capacity], window_fracs=STATIC_WFS,
                              mode="sequential", assoc=assoc,
                              trace_name=args.trace, device=device)
        best = max(r.hit_ratio for r in stat)
        for r in stat:
            print(f"static wf={r.extra['window_frac']:.2f}: "
                  f"hit {r.hit_ratio:.4f}", flush=True)
            rows.append(asdict(r))
        print(f"best static {best:.4f} vs adaptive {a.hit_ratio:.4f} "
              f"({a.hit_ratio - best:+.4f})", flush=True)

    out = args.out or os.path.join(
        OUT_DIR, f"{args.trace}_C{args.capacity}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote", os.path.normpath(out), flush=True)
    return rows


if __name__ == "__main__":
    main()
