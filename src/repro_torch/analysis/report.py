"""Render the window-adaptation table from ``launch/hillclimb.py``'s
trajectory JSONs.

Counterpart of the reference's ``repro/analysis/report.py`` for its one
framework-free table, ``adaptive_table``.  The reference's other tables
(``dryrun_table``, ``roofline_table``, ``collective_summary``, with
``load_cells`` and ``fmt_bytes``) read its XLA dry-run cells
(``experiments/dryrun/*.json``: compiled HLO, TPU roofline terms,
collective counts); the port has no such cells, so they are not ported.

  PYTHONPATH=src python -m repro_torch.analysis.report --what adaptive \\
      [--dir experiments/adaptive_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.hillclimb import OUT_DIR


def adaptive_table(adir):
    """Render launch/hillclimb.py trajectory JSONs: adaptive vs best-static
    hit ratios and where the climber converged."""
    lines = ["| trace | C | adaptive hit | best static | gap | final quota "
             "| epochs |",
             "|---|---|---|---|---|---|---|"]
    for f in sorted(glob.glob(os.path.join(adir, "*.json"))):
        with open(f) as fh:
            rows = json.load(fh)
        ad = [r for r in rows if r.get("extra", {}).get("adaptive")]
        stat = [r for r in rows if not r.get("extra", {}).get("adaptive")]
        for r in ad:
            x = r["extra"]
            tj = x.get("trajectory", {})
            best = max((s["hit_ratio"] for s in stat), default=None)
            gap = f"{r['hit_ratio'] - best:+.4f}" if best is not None else "-"
            beststr = f"{best:.4f}" if best is not None else "-"
            lines.append(
                f"| {r['trace']} | {r['cache_size']} | {r['hit_ratio']:.4f} "
                f"| {beststr} | {gap} | {x.get('final_quota', '-')} "
                f"| {len(tj.get('quota', []))} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help="directory of hillclimb JSONs (default: "
                         "experiments/adaptive_torch)")
    ap.add_argument("--what", default="adaptive", choices=["adaptive"])
    args = ap.parse_args(argv)
    print(adaptive_table(args.dir or OUT_DIR))


if __name__ == "__main__":
    main()
