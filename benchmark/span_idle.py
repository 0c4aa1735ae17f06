"""Idle device time under each host span of the traced window.

``span_idle`` maps the name of every ``span:`` range the host opened in
the window (the benchmark's wrappers and the program's own spans) to
``[wall_s, idle_s, calls]``: the union of its intervals clipped to the
window, the part of that union in which no kernel, copy or memset ran on
the device, and how many of its ranges reach into the window.

The harness reduces a traced window with :func:`benchmark.trace.reduce_trace`
and hands each metric the dict it returns. :func:`install` wraps that
function, once a process, so that its dict also carries ``span_idle``;
every other key is computed by the same lines as before.
"""

from __future__ import annotations

from collections import defaultdict

from . import trace


def span_idle(events) -> dict:
    """``{name: [wall_s, idle_s, calls]}`` from the profiler's events as
    :func:`benchmark.trace._events` gives them ((name, is_device, start
    ns, end ns)), over the ``span:window`` range."""
    (w0, w1), = [(s, e) for n, d, s, e in events if not d and n == trace.WINDOW]
    busy = trace._union([(max(s, w0), min(e, w1)) for n, d, s, e in events
                         if d and not n.startswith("span:") and e > w0 and s < w1])
    ranges = defaultdict(list)
    for n, d, s, e in events:
        if not d and n.startswith("span:") and n != trace.WINDOW and e > w0 and s < w1:
            ranges[n[len("span:"):]].append((max(s, w0), min(e, w1)))
    out = {}
    for name, intervals in ranges.items():
        union = trace._union(intervals)
        wall = sum(e - s for s, e in union)
        out[name] = [wall * 1e-9, (wall - _overlap(union, busy)) * 1e-9, len(intervals)]
    return out


def _overlap(a, b) -> int:
    """Length shared by two sorted lists of disjoint [start, end]."""
    i = j = shared = 0
    while i < len(a) and j < len(b):
        shared += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def install() -> None:
    reduce = trace.reduce_trace
    if getattr(reduce, "adds_span_idle", False):
        return

    def reduce_trace(prof) -> dict:
        return {**reduce(prof), "span_idle": span_idle(trace._events(prof))}

    reduce_trace.adds_span_idle = True
    trace.reduce_trace = reduce_trace


def idle_pct(run, name: str):
    """100 × the idle share of span ``name``'s wall in the traced window,
    or None where the trace has no such span."""
    trace_ = run["trace"]
    entry = None if trace_ is None else trace_.get("span_idle", {}).get(name)
    if entry is None or entry[0] <= 0:
        return None
    return 100.0 * entry[1] / entry[0]
