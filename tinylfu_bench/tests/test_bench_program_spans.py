"""The readers of the program's spans and counter (``lane_split_ms``,
``copy_in_gbps``, ``idle_in_prelude_pct``): each on a hand-built profile
and span log with known gaps, spans and bytes; None with no spans; and a
traced small run of each replay cell reads the two that a CPU run has."""
import pytest

from repro_torch.analysis import program_trace
from tinylfu_bench import harness
from tinylfu_bench.tests.bench_cases import run_small
from tinylfu_bench.yardstick.profile import Profile

SPAN_METRICS = ("lane_split_ms", "copy_in_gbps", "idle_in_prelude_pct")


def _span(name, t0, t1, nbytes=0, parent="engine.run", run=1):
    s = program_trace.Span(name, parent, run, t0)
    s.end_ns = t1
    if nbytes:
        s.counters["bytes_in"] = nbytes
    return s


# window 0..1000 ns; the device busy 100..200 and 600..900, so idle
# 0..100, 200..600 and 900..1000 (600 ns)
PROFILE = Profile(device=[("k", 100, 200), ("sketch_step", 600, 900)],
                  window=(0, 1000))
LOG = [
    _span("engine.run", 20, 990, 5000, parent=None),
    _span("engine.lanes", 50, 150),
    _span("engine.copy_in", 150, 250, 1000),
    _span("engine.state", 300, 400, 4000),
    _span("engine.probes", 380, 500),
    _span("engine.loop", 500, 700),
    _span("engine.finish", 700, 990),
    _span("engine.lanes", 1200, 1300),      # after the window
]


@pytest.fixture
def log(monkeypatch):
    """The reader's span log: ``LOG`` through ``spans_between``."""
    def between(t0, t1):
        return [s for s in LOG if s.start_ns >= t0 and s.end_ns <= t1]
    monkeypatch.setattr(program_trace, "spans_between", between)


def _ctx(profile=PROFILE):
    return harness.Context({}, {}, {}, 0.0, 1e-6, 0, [], profile)


def _read(name, ctx):
    return harness.reader(name).read(ctx)


def test_lane_split_is_the_mean_engine_lanes_span_in_the_window(log):
    # one engine.lanes span (100 ns) lies in the window, one after it
    assert _read("lane_split_ms", _ctx()) == pytest.approx(100 / 1e6)
    LOG.append(_span("engine.lanes", 600, 900, run=2))
    try:
        assert _read("lane_split_ms.lanes", _ctx()) == pytest.approx(
            200 / 1e6)
    finally:
        LOG.pop()


def test_copy_in_rate_is_its_bytes_over_its_time(log):
    # 1,000 bytes in 100 ns; the state's bytes are not the copy's
    assert _read("copy_in_gbps", _ctx()) == pytest.approx(10.0)
    LOG.append(_span("engine.copy_in", 700, 1000, 5000, run=2))
    try:
        assert _read("copy_in_gbps.lanes", _ctx()) == pytest.approx(
            6000 / 400)
    finally:
        LOG.pop()


def test_idle_in_prelude_is_the_idle_share_under_the_prelude_spans(log):
    # idle under lanes 50..100; under copy_in 200..250; under state and
    # probes 300..500 -> 300 of 600 ns; the loop's 500..600 is not prelude
    assert _read("idle_in_prelude_pct", _ctx()) == pytest.approx(50.0)
    assert _read("idle_in_prelude_pct.lanes", _ctx()) == pytest.approx(50.0)


def test_idle_in_prelude_needs_device_operations_and_idle_time(log):
    no_device = Profile(window=(0, 1000))
    assert _read("idle_in_prelude_pct", _ctx(no_device)) is None
    busy = Profile(device=[("k", 0, 1000)], window=(0, 1000))
    assert _read("idle_in_prelude_pct", _ctx(busy)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_give_none_without_spans(name, monkeypatch):
    assert _read(name, _ctx(None)) is None          # not traced
    monkeypatch.setattr(program_trace, "spans_between", lambda a, b: [])
    assert _read(name, _ctx()) is None              # nothing logged
    monkeypatch.delattr(program_trace, "spans_between")
    assert _read(name, _ctx()) is None              # a program without


@pytest.mark.parametrize("cell", ["zipf09-single", "zipf09-tenants64"])
def test_traced_small_run_reads_the_span_metrics(cell):
    r = run_small(cell, traced=True)
    assert r["correct"] is True and r["failed"] == 0
    suffix = "" if cell == "zipf09-single" else ".lanes"
    got = r["metrics"]
    assert got["lane_split_ms" + suffix]["value"] > 0
    assert got["copy_in_gbps" + suffix]["unit"] == "GB/s"
    assert got["copy_in_gbps" + suffix]["value"] > 0
    # a CPU run has no device operation to be idle between
    assert "idle_in_prelude_pct" + suffix not in got
    for b in r["breakdown"]["idle_gaps"]:
        assert not b[0].startswith(("engine.", "facade."))
