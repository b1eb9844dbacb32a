"""Reading a ``torch.profiler`` trace of part of the window.

Copies the arithmetic of ``src/repro_torch/launch/serve.py``'s
``profile_waves`` (device time as the sum of every device event's
duration: kernels, copies and fills, on one stream) and adds the union of
the device intervals (busy time, idle share) and the longest idle gaps,
each named by the harness's host span it falls in. Events are read from
the profiler's raw Kineto results, without building the operator tree.
"""

from __future__ import annotations

import collections
import dataclasses

MARK = "perfbench.clock_mark"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


def events(prof) -> tuple[list[DeviceEvent], dict[str, int]]:
    """(device events, start of each marked host range by name)."""
    from torch.autograd import DeviceType

    dev, marks = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            dev.append(DeviceEvent(e.name(), start, start + e.duration_ns()))
        elif e.name().startswith(MARK):
            marks[e.name()] = e.start_ns()
    dev.sort(key=lambda ev: ev.start_ns)
    return dev, marks


def busy_intervals(evs: list[DeviceEvent], lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: list[list[int]] = []
    for ev in evs:
        s, e = max(ev.start_ns, lo), min(ev.end_ns, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def top_ops(evs: list[DeviceEvent], n: int = 10) -> list[list]:
    """The ``n`` device operations that took the most time, by name."""
    total: collections.Counter = collections.Counter()
    for ev in evs:
        total[ev.name[:120]] += ev.end_ns - ev.start_ns
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]


def label_gaps(gaps: list[tuple[int, int]], spans: list[tuple[str, int, int]],
               n: int = 10) -> list[list]:
    """The ``n`` longest gaps, each named by the host span (label, start,
    end; on the trace's clock) that holds its middle."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) // 2
        label = next((lab for lab, a, b in spans if a <= mid <= b), "harness")
        out.append([label, (e - s) / 1e9])
    return out
