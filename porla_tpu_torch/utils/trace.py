"""Structured tracing & metrics for the protocol engines.

The reference scatters ad-hoc `chrono` timers through its client/server
mains and prints elapsed milliseconds (SURVEY.md §5: Client.cpp / Server.cpp
timing printouts around initialize/update/audit). This replaces them with a
proper subsystem:

- `span(name, **attrs)`: nested wall-clock spans forming a tree
  (contextvar-based, so ZMQ server threads and the in-process transport
  both nest correctly).
- `count(name, n)` / `gauge(name, v)`: monotonic counters / last-value
  gauges attached to the current span's path.
- `summary()`: per-path aggregates (calls, total/mean/max seconds).
- JSONL export of finished spans for offline analysis.

Tracing is OFF by default and costs one `if` per call site. Enable with
`PORLA_TRACE=1` (optionally `PORLA_TRACE_FILE=/path/out.jsonl`) or
programmatically via `enable()`.

GPU caveat: CUDA launches are asynchronous — a span around a launch
measures enqueue unless the caller synchronizes or copies a result to
the host. Protocol call sites wrap host-visible units of work (which end
in such copies), so spans reflect real elapsed time. A span that wraps
launches alone (`point_scale`, `point_butterfly`) times its card work
only under `enable(sync=...)`, which waits for the card before each span's
clock stops.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from dataclasses import dataclass, field

_lock = threading.Lock()
_enabled = os.environ.get("PORLA_TRACE") == "1"
_sync = None                     # called before a span's clock stops
_stack: contextvars.ContextVar[tuple[str, ...]] = contextvars.ContextVar(
    "porla_trace_stack", default=())

_spans: list[dict] = []          # finished spans (insertion order)
_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}


def enable(on: bool = True, sync=None) -> None:
    """Turn the spans on or off. `sync` (e.g. `torch.cuda.synchronize`)
    runs at the end of every span, before its clock stops, so that a span
    covers the card work it launched."""
    global _enabled, _sync
    _enabled = on
    _sync = sync if on else None


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
        _gauges.clear()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a nested unit of work. Attributes must be JSON-serializable."""
    if not _enabled:
        yield
        return
    parent = _stack.get()
    path = parent + (name,)
    token = _stack.set(path)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _sync is not None:
            _sync()
        dt = time.perf_counter() - t0
        _stack.reset(token)
        rec = {"path": "/".join(path), "name": name, "depth": len(parent),
               "elapsed_s": round(dt, 6), "ts": round(t0, 6)}
        if attrs:
            rec["attrs"] = attrs
        with _lock:
            _spans.append(rec)


def spans() -> list[dict]:
    """The finished spans in the order they ended (copies)."""
    with _lock:
        return [dict(s) for s in _spans]


def count(name: str, n: float = 1) -> None:
    if not _enabled:
        return
    key = "/".join(_stack.get() + (name,))
    with _lock:
        _counters[key] = _counters.get(key, 0) + n


def gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    key = "/".join(_stack.get() + (name,))
    with _lock:
        _gauges[key] = value


def summary() -> dict[str, dict]:
    """Aggregate finished spans by path: calls, total/mean/max seconds;
    counters and gauges appended under their own keys."""
    out: dict[str, dict] = {}
    with _lock:
        for s in _spans:
            a = out.setdefault(s["path"], {"calls": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            a["calls"] += 1
            a["total_s"] += s["elapsed_s"]
            a["max_s"] = max(a["max_s"], s["elapsed_s"])
        for path, a in out.items():
            a["total_s"] = round(a["total_s"], 6)
            a["mean_s"] = round(a["total_s"] / a["calls"], 6)
        for k, v in _counters.items():
            out[k] = {"count": v}
        for k, v in _gauges.items():
            out[k] = {"gauge": v}
    return out


def report(file=None) -> str:
    """Human-readable table sorted by total time (widest spans first)."""
    rows = sorted(summary().items(),
                  key=lambda kv: -kv[1].get("total_s", 0))
    lines = [f"{'path':<48} {'calls':>6} {'total_s':>9} {'mean_s':>9}"]
    for path, a in rows:
        if "total_s" in a:
            lines.append(f"{path:<48} {a['calls']:>6} {a['total_s']:>9.3f} "
                         f"{a['mean_s']:>9.4f}")
        elif "count" in a:
            lines.append(f"{path:<48} {'':>6} {a['count']:>9g}     count")
        else:
            lines.append(f"{path:<48} {'':>6} {a['gauge']:>9g}     gauge")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


def _atexit_dump() -> None:
    if _enabled and os.environ.get("PORLA_TRACE_FILE"):
        dump_jsonl()


if os.environ.get("PORLA_TRACE") == "1":
    import atexit
    atexit.register(_atexit_dump)


def dump_jsonl(path: str | None = None) -> str | None:
    """Write finished spans (one JSON object per line) + a final summary
    line. Path defaults to $PORLA_TRACE_FILE; returns the path written."""
    path = path or os.environ.get("PORLA_TRACE_FILE")
    if not path:
        return None
    with _lock:
        spans = list(_spans)
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s) + "\n")
        f.write(json.dumps({"summary": summary()}) + "\n")
    return path
