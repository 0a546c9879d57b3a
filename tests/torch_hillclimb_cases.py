"""Shared by the tests of the port's window-adaptation CLI and its report
against the reference's (tests/test_torch_hillclimb.py,
test_torch_hillclimb_flat.py): one run of a flag list through both CLIs in
process, and the row comparison.  Not a test module; it imports jax and is
not part of the port.

The port's CLI runs with ``--device cpu`` (the plain versions).  Rows must
be equal field for field, bit for bit (hits, hit ratio, final quota, the
trajectory, window fraction, ways, grid), except the fields that say how
and where a row ran: ``wall_s`` and ``extra["grid_wall_s"]`` (host
timings), ``extra["backend"]`` and ``extra["device"]`` (``plain`` on
``cpu`` against the reference's ``jit``).
"""
import contextlib
import copy
import io
import json
import sys
from unittest import mock

from repro.launch import hillclimb as jhc
from repro_torch.launch import hillclimb as thc

HOST_FIELDS = ("wall_s",)
HOST_EXTRA = ("grid_wall_s", "backend", "device")


def run_reference(flags: list, out: str) -> tuple[list, list]:
    """(rows written, lines printed) of the reference CLI."""
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", ["hillclimb", *flags, "--out", out]), \
            contextlib.redirect_stdout(buf):
        jhc.main()
    with open(out) as f:
        return json.load(f), buf.getvalue().splitlines()


def run_port(flags: list, out: str) -> tuple[list, list]:
    """(rows written, lines printed) of the port's CLI on the CPU; the rows
    it returns are the rows it wrote."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = thc.main([*flags, "--device", "cpu", "--out", out])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(rows))
    return written, buf.getvalue().splitlines()


def semantic(row: dict) -> dict:
    row = copy.deepcopy(row)
    for k in HOST_FIELDS:
        row.pop(k)
    for k in HOST_EXTRA:
        row["extra"].pop(k, None)
    return row


def run_cases(cases: list, pdir, rdir) -> dict:
    """Each (case, flags) through both CLIs, JSONs into ``pdir`` (the
    port's) and ``rdir`` (the reference's) under the same names:
    {case: ((port rows, lines), (reference rows, lines))}."""
    out = {}
    for i, (case, flags) in enumerate(cases):
        name = f"{flags[flags.index('--trace') + 1]}_{i}.json"
        out[case] = (run_port(flags, str(pdir / name)),
                     run_reference(flags, str(rdir / name)))
    return out


def check_case(runs: dict, cases: list, case: str):
    """The port's rows and printed lines equal the reference's; the
    adaptive row carries a trajectory over which the climber moved."""
    (ours, p_lines), (ref, r_lines) = runs[case]
    flags = dict(cases)[case]
    assert len(ours) == len(ref) == (6 if "--static-sweep" in flags else 1)
    for a, b in zip(ours, ref):
        assert semantic(a) == semantic(b)
        assert a["extra"]["backend"].startswith("plain")
        assert a["extra"]["device"] == "cpu"
    # every printed line but the last ("wrote <path>") is the reference's
    assert p_lines[:-1] == r_lines[:-1] and len(p_lines) > 10
    assert p_lines[-1].startswith("wrote ")
    adaptive = ours[0]
    assert adaptive["extra"]["adaptive"] is True
    assert adaptive["policy"] == "w-tinylfu(device)+climb"
    tj = adaptive["extra"]["trajectory"]
    assert set(tj) == {"epoch_len", "epoch_hits", "quota"}
    epoch = int(flags[flags.index("--epoch-len") + 1])
    assert tj["epoch_len"] == epoch
    assert len(tj["quota"]) == len(tj["epoch_hits"]) == \
        adaptive["accesses"] // epoch
    # the climber moved the quota after its warm epochs
    assert len(set(tj["quota"])) > 1, tj["quota"]
    if len(ours) > 1:
        fracs = [r["extra"]["window_frac"] for r in ours[1:]]
        assert fracs == list(thc.STATIC_WFS)
        assert all("adaptive" not in r["extra"] for r in ours[1:])
