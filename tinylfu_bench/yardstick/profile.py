"""Reading a finished ``torch.profiler`` run from its raw kineto events
(building the profiler's Python event tree for a long window takes
minutes): the device's operations, the benchmark's own spans and the host's
operations, each as (name, start ns, end ns) on one clock.  The union of
intervals is the arithmetic of the port's ``chip_smoke.device_time_by_kind``,
copied here so that the yardstick does not move with the program."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Profile:
    device: list = field(default_factory=list)   # (name, t0, t1) sorted
    spans: list = field(default_factory=list)    # the benchmark's spans
    host: list = field(default_factory=list)     # other host operations
    window: tuple = (0, 0)                       # the "window" span

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self, events: list) -> list:
        w0, w1 = self.window
        return [e for e in events if e[1] >= w0 and e[2] <= w1]

    def kernels(self, part: str) -> list:
        """Device operations of the window whose name contains ``part``."""
        return [e for e in self.in_window(self.device) if part in e[0]]

    def spans_named(self, name: str) -> list:
        return [s for s in self.in_window(self.spans) if s[0] == name]


def _times(e) -> tuple[int, int]:
    t0 = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)
    dur = (e.duration_ns() if hasattr(e, "duration_ns")
           else int(e.duration_us() * 1e3))
    return t0, t0 + dur


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:160]


def read(prof, span_names) -> Profile:
    """The events of a stopped ``torch.profiler.profile``; ``span_names``
    are the labels of the benchmark's ``record_function`` spans (and
    ``"window"``, which bounds what the readers count)."""
    from torch.autograd import DeviceType
    out = Profile()
    names = set(span_names) | {"window"}
    for e in prof.profiler.kineto_results.events():
        t0, t1 = _times(e)
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in names:       # not a span's mirror on the device
                out.device.append((_short(name), t0, t1))
        elif name in names:
            if name == "window":
                out.window = (t0, t1)
            else:
                out.spans.append((name, t0, t1))
        else:
            out.host.append((name, t0, t1))
    for lst in (out.device, out.spans, out.host):
        lst.sort(key=lambda x: x[1])
    return out


def union(intervals) -> list:
    """Disjoint, sorted union of (t0, t1) intervals."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1][1] = t1
        elif t1 > t0:
            merged.append([t0, t1])
    return merged


def busy_ns(p: Profile) -> int:
    """Window time in which some operation ran on the device."""
    w0, w1 = p.window
    iv = [(max(a, w0), min(b, w1)) for _, a, b in p.device
          if b > w0 and a < w1]
    return sum(b - a for a, b in union(iv))


def idle_gaps(p: Profile) -> list:
    """(t0, t1) stretches of the window with nothing on the device."""
    w0, w1 = p.window
    iv = union((max(a, w0), min(b, w1)) for _, a, b in p.device
               if b > w0 and a < w1)
    gaps, cur = [], w0
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def innermost(events: list, t: int):
    """The latest-starting event of ``events`` (sorted by start) that covers
    time ``t``, which for nested events is the innermost; or None."""
    i = bisect.bisect_right(events, t, key=lambda e: e[1])
    for j in range(i - 1, max(-1, i - 10_000), -1):
        if events[j][2] >= t:
            return events[j]
    return None


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the benchmark's span and the host operation
    that were running at its middle."""
    by_name: dict = {}
    for name, a, b in p.in_window(p.device):
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(p), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        span = innermost(p.spans, mid)
        op = innermost(p.host, mid)
        label = (span[0] if span else "no span") + (
            "/" + op[0] if op else "")
        named.append([label, (b - a) / 1e9])
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": named}
