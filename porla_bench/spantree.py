"""The program's spans as a tree, for the metric readers.

Each span the program records carries its `id`, its `parent` (the id of
the span open around it, or None) and its `root` (the id of the outermost
span of its request). From them a reader finds the leaves of one request:
the spans that no record names as its parent. A span can be a leaf in one
call and a parent in another, so leaves are found record by record, not by
path. Spans without ids (a program that records none) read as nothing:
every function returns None.
"""

from __future__ import annotations

from porla_bench import spans


def unspanned_ms(run, root_path: str, kind: str) -> float | None:
    """The time of the requests whose outermost span is at `root_path`,
    less the time of their leaf spans, in ms per op of `kind`: the time
    that no span names more closely than a parent does."""
    roots = {s["id"]: s["elapsed_s"] for s in run.spans
             if s["path"] == root_path and "id" in s}
    if not roots:
        return None
    parents = {s["parent"] for s in run.spans}
    leaves_s = sum(s["elapsed_s"] for s in run.spans
                   if s.get("root") in roots and s["id"] not in roots
                   and s["id"] not in parents)
    return spans.per_op(run, kind, 1e3 * (sum(roots.values()) - leaves_s))


def named_ms(run, under: str, names: set[str], kind: str) -> float | None:
    """The time of every span named one of `names` at any depth below the
    path `under`, in ms per op of `kind`; None where none ran."""
    ms = 1e3 * sum(s["elapsed_s"] for s in run.spans
                   if s["name"] in names and s["path"].startswith(under + "/"))
    return spans.per_op(run, kind, ms) if ms else None
