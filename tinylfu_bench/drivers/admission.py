"""Driver of the admission cells: one closed-loop client hands
``repro_torch.kernels.ops.DeviceTinyLFU`` its access log in batches.  A
request records the next ``batch`` keys of the stream and then asks for the
admission verdicts of the same keys as candidates, each against the key
accessed before it; it ends when the verdicts are in host memory.  The next
request is sent when the previous one has ended.  When the stream ends, the
next request starts a fresh filter on the stream from its beginning: a
pass.

Set-up makes the stream from the seed and runs one whole pass; its verdicts
and its final sketch are the first pass.  In the window every request's
verdicts are compared with those of the same request of the first pass, and
the sketch at the end of each pass with the first pass's; after the window
the first pass is compared with the reference (``reference/tinylfu.py``).
"""
from __future__ import annotations

import time

import numpy as np

from tinylfu_bench import gen
from tinylfu_bench.reference.tinylfu import TinyLFU
from tinylfu_bench.yardstick import roofline

SPANS = ("request", "record", "admit")


def requests(traffic: dict, seed: int) -> list:
    """One pass of (candidates, victims) requests: ``batch`` consecutive
    keys of the stream each, a key's victim the key accessed before it (the
    stream's last for its first); the keys past the last whole batch are
    not sent."""
    stream = gen.make(traffic, seed)
    b = int(traffic["batch"])
    n = len(stream) // b
    stream = np.ascontiguousarray(stream[:n * b])
    victims = np.roll(stream, 1)
    return [(stream[i * b:(i + 1) * b], victims[i * b:(i + 1) * b])
            for i in range(n)]


def reference_pass(program: dict, reqs: list, work: bool = False,
                   conservative: bool = True):
    """The reference over one pass: (verdicts of each request, final state,
    least seconds by kernel of each request when ``work``)."""
    ref = TinyLFU(program["num_blocks"],
                  sample_factor=program.get("sample_factor", 8),
                  conservative=conservative)
    verdicts, works = [], []
    wpr = ref.width // 8
    for cands, victims in reqs:
        resets = ref.resets
        ref.record(cands)
        verdicts.append(ref.admit(cands, victims))
        if work:
            idx, dkb = ref.probes(cands)
            nb, ops = roofline.add_launch_work(
                idx - np.arange(ref.rows) * ref.width, dkb, wpr)
            record = roofline.least_s(nb, ops)
            if ref.resets > resets:
                record += roofline.least_s(*roofline.reset_launch_work(
                    ref.rows * wpr, ref.dk_bits // 32))
            works.append({"record": record})
    return verdicts, ref.state(), works


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program=None):
        """``program``, when given, makes the filters in ``DeviceTinyLFU``'s
        place and with its signature."""
        if program is None:
            from repro_torch.kernels.ops import DeviceTinyLFU as program
        self.make_filter = program
        self.device = device
        self.program = config["program"]
        self.requests = requests(traffic, seed)
        self.batch = len(self.requests[0][0])
        self.filter = None
        self.r = 0
        self.first = None
        self.first_state = None
        self.verdicts_vs_first = 0
        self.words_vs_first = 0
        self.units_differing = 0
        self.positions = []
        self.works = None

    def _fresh(self):
        return self.make_filter(self.program["num_blocks"],
                                sample_factor=self.program.get(
                                    "sample_factor", 8),
                                device=self.device)

    def _state(self, f) -> dict:
        return {k: v.cpu().numpy().copy() for k, v in f.state.items()}

    def warm(self) -> None:
        f = self._fresh()
        self.first = []
        for cands, victims in self.requests:
            f.record(cands)
            self.first.append(f.admit(cands, victims))
        self.first_state = self._state(f)

    def unit(self, span) -> tuple[float, float, int]:
        if self.r == 0:
            self.filter = self._fresh()
        cands, victims = self.requests[self.r]
        t0 = time.perf_counter()
        with span("request"):
            with span("record"):
                self.filter.record(cands)
            with span("admit"):
                v = self.filter.admit(cands, victims)
        t1 = time.perf_counter()
        bad = count_differ(v, self.first[self.r])
        self.verdicts_vs_first += bad
        self.positions.append(self.r)
        self.r += 1
        if self.r == len(self.requests):
            words = words_differ(self._state(self.filter),
                                  self.first_state)
            self.words_vs_first += words
            bad += words
            self.r = 0
        self.units_differing += bool(bad)
        return t0, t1, self.batch

    def check(self, traced: bool) -> dict:
        verdicts, state, works = reference_pass(self.program, self.requests,
                                                work=traced)
        bad = sum(count_differ(a, b) for a, b in zip(self.first, verdicts))
        words = words_differ(self.first_state, state)
        self.works = works
        self.wrong_first = bool(bad or words)
        return {"verdicts_vs_reference": (bad, 0),
                "words_vs_reference": (words, 0),
                "verdicts_vs_first": (self.verdicts_vs_first, 0),
                "words_vs_first": (self.words_vs_first, 0)}

    def failed(self, attempted: int) -> int:
        return attempted if self.wrong_first else self.units_differing

    def unit_work(self, i: int) -> dict:
        return self.works[self.positions[i]] if self.works else {}


def count_differ(got, want: np.ndarray) -> int:
    """Elements of ``got`` unequal to ``want``'s; all of them when the
    shapes differ."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return want.size
    return int((got != want).sum())


def words_differ(got: dict, want: dict) -> int:
    """State words of ``got`` unequal to ``want``'s, leaf by leaf."""
    return sum(count_differ(got.get(k, np.zeros(0)), v)
               for k, v in want.items())
