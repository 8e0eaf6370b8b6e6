"""Arithmetic over a run's ops and the program's spans, shared by the
metric readers.

Every quantity is taken over all the ops the window completed: a mean is
the total over the count, a percentile is of every op's time, and a
span's time is its total over the window divided by the ops.
"""

from __future__ import annotations


def op_ms(run, kind: str) -> list[float]:
    """Milliseconds of every completed op of one kind, in order."""
    return [op["ms"] for op in run.ops if op["kind"] == kind and op["ok"]]


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def percentile(values, q: float) -> float | None:
    """The q-th percentile of all values, interpolated linearly between
    the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def total_ms(run, path: str) -> float:
    """Milliseconds of every span at `path` (names joined by "/", from a
    top-level span) over the window."""
    return 1e3 * sum(s["elapsed_s"] for s in run.spans if s["path"] == path)


def per_op(run, kind: str, ms: float) -> float | None:
    """`ms` over the window's completed ops of one kind."""
    n = len(op_ms(run, kind))
    if not n or not run.spans:
        return None
    return ms / n


def self_ms(run, path: str, child: str) -> float | None:
    """A span's time less that of its child `child` (a name), over the
    window; None where the span never ran."""
    if not any(s["path"] == path for s in run.spans):
        return None
    return total_ms(run, path) - total_ms(run, path + "/" + child)
