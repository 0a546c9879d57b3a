"""What decides ``correct`` can fail: the control (the reference with a
guarantee broken) reads above every limit it is held to, and a run whose
timed path is broken underneath comes out not correct, for each fault a
cell can have: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced.  (The cells run on one
card: no exchange between chips to leave out.)  The runs skip the look for
a card and run the plain versions on the CPU at small sizes."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from tinylfu_bench import control
from tinylfu_bench.tests.bench_cases import (BATCHES, LANES, SINGLE,
                                             control_small, run_small)

REPLAY_CELLS = ("zipf09-single", "zipf09-tenants64")


def _over(r: dict, name: str) -> bool:
    c = r["checks"][name]
    return c["value"] > c["limit"]


@pytest.mark.parametrize("cell,traffic", [("zipf09-single", SINGLE),
                                          ("zipf09-tenants64", LANES)],
                         ids=["single", "lanes"])
def test_replay_control_fails_every_number(cell, traffic):
    r = control_small(cell, dict(traffic, chunk=64))
    assert r["correct"] is False and r["failed"] == r["attempted"]
    assert _over(r, "flags_vs_reference") and _over(r, "words_vs_reference")
    assert not _over(r, "flags_vs_first")


def test_admission_control_fails_a_number():
    big = dict(BATCHES, args=dict(BATCHES["args"], length=6000))
    r = control_small("admit-zipf09-b16384", big)
    assert r["correct"] is False
    assert _over(r, "words_vs_reference")


def test_control_main_exits_zero_when_every_seed_fails(monkeypatch, capsys):
    monkeypatch.setattr(control, "control_run",
                        lambda *a, **k: {"correct": False, "checks": {
                            "flags_vs_reference": {"value": 3, "limit": 0}}})
    assert control.main(["--workload", "zipf09-single", "--seed", "1",
                         "2"]) == 0
    assert "flags_vs_reference 3 limit 0" in capsys.readouterr().out
    monkeypatch.setattr(control, "control_run",
                        lambda *a, **k: {"correct": True, "checks": {}})
    assert control.main(["--workload", "zipf09-single", "--seed", "1"]) == 1


def _patch_step(monkeypatch, wrap):
    from repro_torch.core import device_simulate
    real = device_simulate.step
    calls = []

    def step(spec, params, state, lo, hi, n_valid=None, probes=None,
             rank=0):
        calls.append(1)
        return wrap(real, len(calls), spec, params, state, lo, hi, n_valid,
                    probes)
    monkeypatch.setattr(device_simulate, "step", step)


def _unchanged(real, i, spec, params, state, lo, hi, n, probes):
    return state, torch.zeros(lo.shape, dtype=torch.int32)


def _half(real, i, spec, params, state, lo, hi, n, probes):
    if spec.streams == 1:         # half of the chunk's accesses
        n = lo.shape[-1] if n is None else n
        return real(spec, params, state, lo, hi, n // 2, probes)
    h = spec.streams // 2         # half of the lanes
    hits = torch.zeros(lo.shape, dtype=torch.int32)
    _, hits[:h] = real(replace(spec, streams=h), params,
                       {k: v[:h] for k, v in state.items()}, lo[:h], hi[:h],
                       n[:h] if isinstance(n, list) else n,
                       tuple(p[:h] for p in probes))
    return state, hits


def _altered(in_window_only):
    """Flip the first hit flag of every lane in every launch (the first
    replay's too), or only in the window's launches."""
    def wrap(real, i, *args):
        state, hits = real(*args)
        if _WINDOW[0] or not in_window_only:
            hits = hits.clone()
            hits[..., 0] ^= 1
        return state, hits
    return wrap


_WINDOW = [False]


@pytest.fixture
def window_flag(monkeypatch):
    """Raise ``_WINDOW[0]`` once a driver's set-up is done."""
    from tinylfu_bench.drivers import admission, replay
    for drv in (admission, replay):
        def armed(self, warm=drv.Session.warm):
            warm(self)
            _WINDOW[0] = True
        monkeypatch.setattr(drv.Session, "warm", armed)
    _WINDOW[0] = False
    yield
    _WINDOW[0] = False


@pytest.mark.parametrize("cell", REPLAY_CELLS)
@pytest.mark.parametrize("fault,wrap", [
    ("unchanged", _unchanged), ("half", _half),
    ("altered-everywhere", _altered(False)),
    ("altered-in-the-window", _altered(True))])
def test_replay_faults_come_out_not_correct(monkeypatch, window_flag, cell,
                                            fault, wrap):
    _patch_step(monkeypatch, wrap)
    r = run_small(cell)
    assert r["correct"] is False
    assert r["failed"] >= 1


@pytest.mark.parametrize("lane", [0, 5, 7])
def test_a_fault_in_one_lane_comes_out_not_correct(monkeypatch, lane):
    """One hit flag of one lane altered in every replay, the first too: only
    the reference sees it, over every lane."""
    def wrap(real, i, *args):
        state, hits = real(*args)
        hits = hits.clone()
        hits[lane, 0] ^= 1
        return state, hits
    _patch_step(monkeypatch, wrap)
    r = run_small("zipf09-tenants64")
    assert r["correct"] is False and r["failed"] == r["attempted"]
    assert r["checks"]["flags_vs_reference"]["value"] >= 1
    assert r["checks"]["flags_vs_first"]["value"] == 0


class _Record:
    """A DeviceTinyLFU broken in one of the ways above (the answer altered
    in the window's first request)."""

    def __new__(cls, fault):
        from repro_torch.kernels.ops import DeviceTinyLFU

        class Broken(DeviceTinyLFU):
            def record(self, keys):
                if fault == "unchanged":
                    return None
                if fault == "half":
                    return super().record(keys[:len(keys) // 2])
                return super().record(keys)

            def admit(self, cands, victims):
                v = super().admit(cands, victims)
                if fault == "altered" and _WINDOW[0]:
                    v = v.copy()
                    v[0] = not v[0]
                    _WINDOW[0] = False
                return v
        return Broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_admission_faults_come_out_not_correct(monkeypatch, window_flag,
                                               fault):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "DeviceTinyLFU", _Record(fault))
    r = run_small("admit-zipf09-b16384")
    assert r["correct"] is False
    assert r["failed"] >= 1


def test_sound_runs_stay_correct_under_the_same_patching(monkeypatch):
    _patch_step(monkeypatch, lambda real, i, *args: real(*args))
    assert run_small("zipf09-tenants64")["correct"] is True
    assert np.all([c["value"] == 0 for c in
                   run_small("zipf09-single")["checks"].values()])
