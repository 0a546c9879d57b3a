"""The port's window-adaptation CLI (``repro_torch.launch.hillclimb``) and its
report (``repro_torch.analysis.report.adaptive_table``) against the
reference's (``repro.launch.hillclimb``, ``repro.analysis.report``), JAX on
the CPU.

Both CLIs run in process on the same flags at a small size (C=100, 512 and
1,024 accesses at 8 ways, climb epochs of 32 and 64 so that the climber
moves the quota after its warm epochs; the flat tables in
test_torch_hillclimb_flat.py); the port's with ``--device cpu`` (the plain
versions).  Their JSON rows and printed lines must be equal
(``tests/torch_hillclimb_cases.py`` says which fields are left out and
why).  Both packages' ``adaptive_table`` must render the same strings over
the reference's committed ``experiments/adaptive/`` and over both CLIs'
output.  ``is_subquadratic`` is held to the reference's over every
config.

Run as a script, the file prints ``check_runs.HC_PINS`` and ``HC_TABLE``:
the reference CLI at its full size (``check_runs.HC_RUNS``; ~2 min of JAX
on the CPU).
"""
import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro.analysis import report as jreport
from repro.launch import hillclimb as jhc
from repro_torch.analysis import report as treport
from repro_torch.launch import hillclimb as thc
from torch_hillclimb_cases import (check_case, run_cases, run_port,
                                   run_reference, semantic)

ROOT = Path(__file__).resolve().parents[1]
TRACES = ("zipf", "fickle", "phase", "youtube", "wiki", "oltp", "spc1",
          "glimpse")

# (case id, flags): phase at 8 ways with the static sweep; fickle from a
# wide window, adaptive only (the flat tables: test_torch_hillclimb_flat.py)
CASES = [
    ("phase-assoc8-sweep",
     ["--trace", "phase", "--capacity", "100", "--length", "512",
      "--epoch-len", "32", "--assoc", "8", "--static-sweep"]),
    ("fickle-assoc8",
     ["--trace", "fickle", "--capacity", "100", "--length", "1024",
      "--epoch-len", "64", "--window-frac", "0.2"]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pdir = tmp_path_factory.mktemp("port")
    rdir = tmp_path_factory.mktemp("reference")
    return run_cases(CASES, pdir, rdir), pdir, rdir


@pytest.mark.parametrize("name", TRACES)
def test_make_trace_equals_reference(name):
    for length, seed in ((2_000, 3), (777, 11)):
        ours = thc.make_trace(name, length, seed)
        ref = jhc.make_trace(name, length, seed)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name


def test_unknown_trace_exits_like_reference():
    with pytest.raises(SystemExit, match="unknown trace 'nope'"):
        thc.make_trace("nope", 10, 0)
    with pytest.raises(SystemExit, match="unknown trace 'nope'"):
        jhc.make_trace("nope", 10, 0)


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_cli_rows_equal_reference(runs, case):
    check_case(runs[0], CASES, case)


def test_short_trace_writes_no_trajectory(tmp_path):
    flags = ["--trace", "zipf", "--capacity", "50", "--length", "200",
             "--epoch-len", "256"]
    ours, p_lines = run_port(flags, str(tmp_path / "p.json"))
    ref, r_lines = run_reference(flags, str(tmp_path / "r.json"))
    assert len(ours) == len(ref) == 1
    assert "trajectory" not in ours[0]["extra"]
    assert "trajectory" not in ref[0]["extra"]
    assert semantic(ours[0]) == semantic(ref[0])
    assert p_lines[:-1] == r_lines[:-1] and len(p_lines) == 3
    assert "no climb ran; lower --epoch-len" in p_lines[1]


def test_cli_defaults_to_the_card():
    """No ``--device``: the card, and no CPU fallback where there is none."""
    args = thc.parse_args([])
    assert args.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thc.main(["--length", "10", "--out", os.devnull])


def test_cli_flags_and_defaults_match_reference():
    """Every reference flag with its default, plus ``--device``."""
    captured = {}

    def grab(ap, *args, **kw):
        captured["ap"] = ap
        raise StopIteration

    with mock.patch("argparse.ArgumentParser.parse_args", grab):
        with pytest.raises(StopIteration):
            jhc.main()
    ref = vars(captured["ap"].parse_known_args([])[0])
    ours = vars(thc.parse_args([]))
    assert ours.pop("device") is None
    assert ours == ref
    assert thc.STATIC_WFS == jhc.STATIC_WFS


def test_default_out_dir_is_not_the_reference_runs():
    ours = Path(thc.OUT_DIR).resolve()
    ref_dir = Path(jhc.OUT_DIR).resolve()
    assert ref_dir == ROOT / "experiments" / "adaptive"
    assert ours == ROOT / "experiments" / "adaptive_torch"
    assert ours != ref_dir and ref_dir not in ours.parents
    assert Path(treport.OUT_DIR).resolve() == ours


def test_adaptive_table_over_committed_reference_runs():
    adir = str(ROOT / "experiments" / "adaptive")
    table = treport.adaptive_table(adir)
    assert table == jreport.adaptive_table(adir)
    assert len(table.splitlines()) == 2 + 2     # phase and fickle


def test_adaptive_table_over_port_runs(runs):
    _, pdir, rdir = runs
    ours = treport.adaptive_table(str(pdir))
    assert ours == jreport.adaptive_table(str(pdir))
    # the reference's own JSONs render the same table
    assert ours == jreport.adaptive_table(str(rdir))
    assert len(ours.splitlines()) == 2 + len(CASES)
    assert "| - | - |" in ours          # the adaptive-only case: no static


def test_hc_table_follows_from_hc_pins(tmp_path):
    """chip_smoke's HC pins and table agree: rows carrying only the pinned
    hits, quotas and epoch counts render HC_TABLE in both packages."""
    from repro_torch.check_runs import HC_PINS, HC_RUNS, HC_TABLE
    assert [t for t, _ in HC_RUNS] == list(HC_PINS)
    for trace, flags in HC_RUNS:
        args = thc.parse_args(["--trace", trace, *flags])
        n, pins = args.length, HC_PINS[trace]
        hits, quota, nep, _ = pins["adaptive"]
        assert nep == n // args.epoch_len
        rows = [{"trace": trace, "cache_size": args.capacity,
                 "hit_ratio": hits / n,
                 "extra": {"adaptive": True, "final_quota": quota,
                           "trajectory": {"quota": [0] * nep}}}]
        rows += [{"trace": trace, "cache_size": args.capacity,
                  "hit_ratio": h / n, "extra": {}} for h in pins["static"]]
        (tmp_path / f"{trace}.json").write_text(json.dumps(rows))
    table = treport.adaptive_table(str(tmp_path))
    assert table == jreport.adaptive_table(str(tmp_path))
    assert tuple(table.splitlines()) == HC_TABLE


def test_report_main(runs, capsys):
    _, pdir, _ = runs
    treport.main(["--what", "adaptive", "--dir", str(pdir)])
    assert capsys.readouterr().out == treport.adaptive_table(str(pdir)) + "\n"
    with pytest.raises(SystemExit):
        treport.main(["--what", "roofline"])
    capsys.readouterr()


def test_is_subquadratic_equals_reference():
    from repro.configs import get_config as jget
    from repro.models import is_subquadratic as jsub
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import is_subquadratic
    seen = set()
    for arch in list_archs():
        for smoke in (False, True):
            ours = is_subquadratic(get_config(arch, smoke=smoke))
            assert ours == jsub(jget(arch, smoke=smoke)), arch
            seen.add(ours)
    assert seen == {False, True}


if __name__ == "__main__":
    import tempfile

    from repro_torch.check_runs import HC_RUNS, hc_pins
    d = tempfile.mkdtemp()
    pins = {}
    for trace, flags in HC_RUNS:
        rows, _ = run_reference(["--trace", trace, *flags, "--static-sweep"],
                                os.path.join(d, f"{trace}.json"))
        pins[trace] = hc_pins(rows)
    print("HC_PINS =", pins)
    print("HC_TABLE =", tuple(jreport.adaptive_table(d).splitlines()))
