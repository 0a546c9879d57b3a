"""The port's window-adaptation CLI on the exact flat tables (``--assoc 0``)
against the reference's, JAX on the CPU: with the static sweep and
adaptive only, rows and printed lines equal (``tests/torch_hillclimb_cases.py``
says which fields are left out and why), and both packages'
``adaptive_table`` over both CLIs' output equal.  C=100, 512 accesses,
climb epochs of 32 so that the climber moves the quota after its warm
epochs.
"""
import pytest

from repro.analysis import report as jreport
from repro_torch.analysis import report as treport
from torch_hillclimb_cases import check_case, run_cases

CASES = [
    ("phase-flat-sweep",
     ["--trace", "phase", "--capacity", "100", "--length", "512",
      "--epoch-len", "32", "--assoc", "0", "--static-sweep"]),
    ("zipf-flat",
     ["--trace", "zipf", "--capacity", "100", "--length", "512",
      "--epoch-len", "32", "--assoc", "0", "--window-frac", "0.2"]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pdir = tmp_path_factory.mktemp("port")
    rdir = tmp_path_factory.mktemp("reference")
    return run_cases(CASES, pdir, rdir), pdir, rdir


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_flat_cli_rows_equal_reference(runs, case):
    check_case(runs[0], CASES, case)
    ours = runs[0][case][0][0]
    assert all(r["extra"]["assoc"] is None for r in ours)


def test_flat_adaptive_table(runs):
    _, pdir, rdir = runs
    ours = treport.adaptive_table(str(pdir))
    assert ours == jreport.adaptive_table(str(pdir)) \
        == jreport.adaptive_table(str(rdir))
    assert len(ours.splitlines()) == 2 + len(CASES)
