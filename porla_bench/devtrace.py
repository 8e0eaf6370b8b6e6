"""The device's timeline from `torch.profiler`, and what it says.

A traced run profiles the card's activity (CUDA kernels, copies and
fills) over the window. Its times are on the host's wall clock in
nanoseconds (`time.time_ns()`); the program's spans, timed with
`time.perf_counter()`, are mapped onto it through one pair of readings of
both clocks taken as the window opens.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

_GLOBAL = re.compile(r"__global__\s+void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


@dataclass
class DeviceTrace:
    """Device activities [(start_ns, end_ns, name)] inside the window."""
    intervals: list
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Clock:
    """Maps `perf_counter` seconds onto the profiler's nanoseconds."""

    def __init__(self):
        self.pc0 = time.perf_counter()
        self.ns0 = time.time_ns()

    def ns(self, pc: float) -> int:
        return self.ns0 + round((pc - self.pc0) * 1e9)


def profiler():
    """A started profiler of the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def collect(prof, start_ns: int, end_ns: int) -> DeviceTrace:
    """Stop `prof` and keep its device activities that overlap the window,
    clipped to it."""
    from torch.autograd import DeviceType
    prof.__exit__(None, None, None)
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e <= start_ns or s >= end_ns:
            continue
        out.append((max(s, start_ns), min(e, end_ns), ev.name()))
    out.sort()
    return DeviceTrace(out, start_ns, end_ns)


def union(intervals) -> list[tuple[int, int]]:
    """Merge (start, end, ...) intervals sorted by start."""
    merged: list = []
    for s, e, *_ in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(intervals, windows) -> int:
    """Nanoseconds inside the disjoint [lo, hi) `windows` in which some of
    the (start, end, ...) `intervals` (sorted by start) is active."""
    merged = union(intervals)
    total, j = 0, 0
    for lo, hi in sorted(windows):
        while j < len(merged) and merged[j][1] <= lo:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < hi:
            total += min(merged[k][1], hi) - max(merged[k][0], lo)
            k += 1
    return total


def kernel_names(sources) -> set[str]:
    """The `__global__` function names defined in CUDA source files."""
    names = set()
    for path in sources:
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    head = name.replace("(anonymous namespace)", "anon").split("(", 1)[0]
    head = head.strip()
    return (head[5:] if head.startswith("void ") else head)[:96]


def is_kernel(name: str, names: set[str]) -> bool:
    """Whether a trace entry is one of the functions `names` lists
    (templates included)."""
    return short_name(name).split("<", 1)[0] in names


def op_intervals_ns(run, kind: str) -> list[tuple[int, int]]:
    """The [start, end) nanoseconds of the window's ops of one kind."""
    return [(op["t0_ns"], op["t1_ns"]) for op in run.ops if op["kind"] == kind]


def idle_gaps(trace: DeviceTrace, spans, clock: Clock, top: int = 10):
    """Idle seconds of the card by what the host was doing: each gap
    between device activities goes to the deepest span holding its
    midpoint, "(outside spans)" where none does; the `top` largest."""
    placed = sorted((clock.ns(s["ts"]), clock.ns(s["ts"] + s["elapsed_s"]),
                     s["depth"], s["path"]) for s in spans)
    busy = union(trace.intervals)
    gaps, t = [], trace.start_ns
    for s, e in busy + [(trace.end_ns, trace.end_ns)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    by: dict[str, float] = {}
    active, i = [], 0
    for g0, g1 in gaps:                 # a sweep: gaps and spans by time
        mid = (g0 + g1) // 2
        while i < len(placed) and placed[i][0] <= mid:
            active.append(placed[i][1:])
            i += 1
        active = [a for a in active if a[0] >= mid]
        best = max(active, key=lambda a: a[1])[2] if active \
            else "(outside spans)"
        by[best] = by.get(best, 0.0) + (g1 - g0) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def device_ops(trace: DeviceTrace, top: int = 10):
    """The `top` device operations by their total seconds."""
    by: dict[str, float] = {}
    for s, e, name in trace.intervals:
        k = short_name(name)
        by[k] = by.get(k, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
