"""The span log of ``analysis.program_trace``: the engine's phases and the
``DeviceTinyLFU`` facade's steps as spans, on while a ``torch.profiler``
records and on the profiler's clock, and the ``bytes_in`` counter.  With
no profiler nothing is logged, and spans on or off the recorded program
is the same (the spans dispatch no op)."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.analysis import program_trace
from repro_torch.analysis.program_lint import render
from repro_torch.core import device_simulate as ds
from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels.ops import DeviceTinyLFU
from repro_torch.traces.synthetic import zipf_trace

ENGINE = ["engine.lanes", "engine.copy_in", "engine.state", "engine.probes",
          "engine.loop", "engine.finish"]
GEO = dict(assoc=8, window_frac=0.05, sample_factor=8, rows=4,
           counter_bits=4, doorkeeper=True)
CAP, N, CHUNK, WARMUP = 64, 200, 64, 50


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trace(streams: int = 1) -> np.ndarray:
    rows = [zipf_trace(N, n_items=300, alpha=0.9, seed=11 + i)
            for i in range(streams)]
    return rows[0] if streams == 1 else np.stack(rows)


def _profiled(fn):
    """(what ``fn()`` returned, the spans logged while it ran inside the
    profiled ``record_function`` "outer", that span's (start, end) on the
    profiler's clock)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            t0 = time.time_ns()
            out = fn()
            t1 = time.time_ns()
    outer = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "outer"]
    assert len(outer) == 1
    a = outer[0].start_ns()
    return out, program_trace.spans_between(t0, t1), (
        a, a + outer[0].duration_ns())


def _engine_run(streams: int = 1, **kw):
    tr = _trace(streams)
    if streams > 1:
        kw["streams"] = streams
    return lambda: ds.simulate_trace(tr, CAP, warmup=WARMUP, chunk=CHUNK,
                                     device="cpu", return_state=True,
                                     **GEO, **kw)


def _children(spans, root):
    return [s for s in spans if s.run == root.run and s is not root]


def _state_bytes(streams: int = 1, **kw) -> int:
    cfg = ds.DeviceWTinyLFU(CAP, **GEO, **kw)
    st = ks.init_step_state(cfg.spec(), cfg.window_cap, cfg.main_cap,
                            device="cpu")
    return sum(v.nbytes for v in st.values())


@pytest.mark.parametrize("streams", [1, 2])
def test_engine_run_is_one_root_its_six_children_tile_it(streams):
    _, spans, _ = _profiled(_engine_run(streams))
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["engine.run"]
    root = roots[0]
    kids = _children(spans, root)
    assert [s.name for s in kids] == ENGINE
    assert {s.parent for s in kids} == {"engine.run"}
    assert {s.run for s in spans} == {root.run}
    # in order, no two overlap, all inside the root, and what they leave
    # uncovered of it is the Python between two phases
    assert root.start_ns <= kids[0].start_ns
    for a, b in zip(kids, kids[1:]):
        assert a.start_ns < a.end_ns <= b.start_ns
    assert kids[-1].end_ns <= root.end_ns
    covered = sum(s.duration_ns for s in kids)
    assert root.duration_ns - covered < 0.01 * root.duration_ns


def test_each_engine_call_is_a_run_of_its_own():
    _, spans, _ = _profiled(lambda: [_engine_run()() for _ in range(2)])
    roots = [s for s in spans if s.name == "engine.run"]
    assert len(roots) == 2 and roots[0].run != roots[1].run
    for r in roots:
        assert [s.name for s in _children(spans, r)] == ENGINE


def test_a_segmented_run_has_probes_and_loop_a_segment():
    tr = _trace()
    cfg = ds.DeviceWTinyLFU(CAP, **GEO)
    _, spans, _ = _profiled(lambda: cfg.run(
        tr, warmup=WARMUP, chunk=CHUNK, device="cpu", checkpoint_every=64,
        fault_hook=lambda cursor, state: None))
    root, = [s for s in spans if s.name == "engine.run"]
    names = [s.name for s in _children(spans, root)]
    segments = -(-N // 64)
    assert segments > 1
    assert names == (ENGINE[:3] + ["engine.probes", "engine.loop"] * segments
                     + ["engine.finish"])


def test_spans_lie_inside_the_enclosing_record_function():
    _, spans, (a, b) = _profiled(_engine_run())
    assert len(spans) == 1 + len(ENGINE)
    for s in spans:
        assert a <= s.start_ns <= s.end_ns <= b, (s, a, b)


def test_spans_are_on_the_profilers_clock():
    """A span opened right after a ``record_function`` starts within 0.3
    ms of it, on the profiler's timestamps."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with record_function(f"mark{i}"):
                with program_trace.span(f"clock{i}"):
                    pass
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in program_trace.spans_between(
        min(starts.values()) - 10**9, time.time_ns())}
    for i in range(5):
        assert abs(spans[f"clock{i}"].start_ns - starts[f"mark{i}"]) < 300_000


@pytest.mark.parametrize("streams,kw", [(1, {}), (2, {}),
                                        (1, {"adaptive": True})])
def test_bytes_in_counts_every_host_array_placed_on_the_device(streams, kw):
    (_, state, _), spans, _ = _profiled(_engine_run(streams, **kw))
    root, = [s for s in spans if s.name == "engine.run"]
    copy_in, = [s for s in spans if s.name == "engine.copy_in"]
    tr = _trace(streams)
    lanes = 2 * 4 * tr.size                     # lo and hi, int32
    extra = 0
    if kw.get("adaptive"):
        cfg = ds.DeviceWTinyLFU(CAP, **GEO, **kw)
        extra = ds.ClimbSpec().resolve(cfg).nbytes
    assert copy_in.counters == {"bytes_in": lanes}
    assert root.counters == {"bytes_in": lanes + 4 * ks.NPARAMS
                             + _state_bytes(**kw) + extra}
    # one lane's state is placed and repeated on the device
    assert sum(v.nbytes for v in state.values()) == streams * _state_bytes(
        **kw)


@pytest.mark.parametrize("streams", [1, 2])
def test_a_64_bit_trace_is_copied_as_it_is(streams):
    """A uint64 or int64 trace is not converted on the host: its
    ``engine.lanes`` span carries no counter, and ``engine.copy_in``
    carries its 8 bytes a key (lo and hi, split on the device)."""
    tr = _trace(streams)
    assert tr.dtype in (np.uint64, np.int64) and tr.flags.c_contiguous
    for keys in (tr, tr.astype(np.uint64)):
        _, spans, _ = _profiled(lambda: ds.simulate_trace(
            keys, CAP, warmup=WARMUP, chunk=CHUNK, device="cpu",
            **GEO, **({"streams": streams} if streams > 1 else {})))
        lanes, = [s for s in spans if s.name == "engine.lanes"]
        copy_in, = [s for s in spans if s.name == "engine.copy_in"]
        assert lanes.counters == {}
        assert copy_in.counters == {"bytes_in": 8 * keys.size}


def test_no_profiler_no_spans_and_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    sp = program_trace.span("engine.run")
    assert sp is program_trace.NULL_SPAN
    assert program_trace.span("facade.admit") is sp
    t0 = time.time_ns()
    _engine_run()()
    d = DeviceTinyLFU(16, device="cpu")
    keys = np.arange(40, dtype=np.uint64)
    d.record(keys)
    d.admit(keys[:5], keys[5:10])
    program_trace.count("bytes_in", 10)
    assert program_trace.spans_between(t0, time.time_ns()) == []


def test_recorded_program_is_the_same_with_spans_on_and_off():
    def recorded(spans_on: bool) -> str:
        prof = (profile(activities=[ProfilerActivity.CPU]) if spans_on
                else None)
        if prof is not None:
            prof.__enter__()
        try:
            t0 = time.time_ns()
            with program_trace.record() as rec:
                _engine_run()()
            logged = program_trace.spans_between(t0, time.time_ns())
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        assert bool(logged) == spans_on
        return render(rec.events)

    on, off = recorded(True), recorded(False)
    assert "launch sketch_step" in off and "op aten." in off
    assert on == off


def test_the_log_is_a_bounded_ring_and_counters_roll_up():
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with program_trace.span("outer"):
            program_trace.count("bytes_in", 3)
            with program_trace.span("inner"):
                program_trace.count("bytes_in", 4)
        for _ in range(program_trace.SPAN_LOG_SIZE + 10):
            with program_trace.span("filler"):
                pass
    spans = program_trace.spans_between(t0, time.time_ns())
    assert len(spans) == program_trace.SPAN_LOG_SIZE
    assert {s.name for s in spans} == {"filler"}
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with program_trace.span("outer"):
            program_trace.count("bytes_in", 3)
            with program_trace.span("inner"):
                program_trace.count("bytes_in", 4)
    outer, inner = program_trace.spans_between(t0, time.time_ns())
    assert (outer.name, inner.name, inner.parent) == ("outer", "inner",
                                                      "outer")
    assert inner.counters == {"bytes_in": 4}
    assert outer.counters == {"bytes_in": 7}
    assert outer.run == inner.run


def test_facade_calls_are_spans_with_lanes_copy_in_and_verdict_read():
    d = DeviceTinyLFU(64, device="cpu")
    keys = np.arange(1000, 1300, dtype=np.uint64)
    cands, victims = keys[:50], keys[50:100]

    def calls():
        d.record(keys)
        est = d.estimate(keys[:70])
        return est, d.admit(cands, victims)

    (est, verdicts), spans, (a, b) = _profiled(calls)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["facade.record", "facade.estimate",
                                       "facade.admit"]
    assert len({s.run for s in roots}) == 3
    want = {"facade.record": (["facade.lanes", "facade.copy_in"], 8 * 300),
            "facade.estimate": (["facade.lanes", "facade.copy_in",
                                 "facade.verdict_read"], 8 * 70),
            "facade.admit": (["facade.lanes", "facade.copy_in",
                              "facade.verdict_read"], 2 * 8 * 50)}
    for r in roots:
        kids = _children(spans, r)
        names, nbytes = want[r.name]
        assert [s.name for s in kids] == names
        assert r.start_ns <= kids[0].start_ns
        for x, y in zip(kids, kids[1:]):
            assert x.end_ns <= y.start_ns
        assert kids[-1].end_ns <= r.end_ns and a <= r.start_ns
        assert r.end_ns <= b
        assert r.counters == {"bytes_in": nbytes}
        assert kids[1].counters == {"bytes_in": nbytes}
    assert est.shape == (70,) and verdicts.shape == (50,)
