"""The device's wall under each host span of the traced window.

``torch.profiler`` puts each ``span:`` range the host opened on the
device's timeline too, from the start of the first kernel, copy or
memset launched inside it to the end of the last (the innermost range
holds each launch). ``device_spans`` maps each name to ``[wall_s,
ranges]``: the union of those device intervals clipped to the window,
and how many reach into it. A span that does not synchronize closes on
the host when its work is queued; its device wall is when that work ran.

:func:`install` wraps :func:`benchmark.trace.reduce_trace`, once a
process, so that its dict also carries ``device_spans``; every other key
is computed by the same lines as before.
"""

from __future__ import annotations

from collections import defaultdict

from . import trace


def device_spans(events) -> dict:
    """``{name: [wall_s, ranges]}`` from the profiler's events as
    :func:`benchmark.trace._events` gives them ((name, is_device, start
    ns, end ns)), over the ``span:window`` range."""
    (w0, w1), = [(s, e) for n, d, s, e in events if not d and n == trace.WINDOW]
    ranges = defaultdict(list)
    for n, d, s, e in events:
        if d and n.startswith("span:") and e > w0 and s < w1:
            ranges[n[len("span:"):]].append((max(s, w0), min(e, w1)))
    return {name: [sum(e - s for s, e in trace._union(iv)) * 1e-9, len(iv)] for name, iv in ranges.items()}


def install() -> None:
    reduce = trace.reduce_trace
    if getattr(reduce, "adds_device_spans", False):
        return

    def reduce_trace(prof) -> dict:
        return {**reduce(prof), "device_spans": device_spans(trace._events(prof))}

    reduce_trace.adds_device_spans = True
    reduce_trace.adds_span_idle = getattr(reduce, "adds_span_idle", False)
    trace.reduce_trace = reduce_trace


def wall_s(run, name: str):
    """Seconds the device spent under span ``name`` in the traced window,
    or None where the trace has no such span."""
    trace_ = run["trace"]
    entry = None if trace_ is None else trace_.get("device_spans", {}).get(name)
    return None if entry is None or entry[0] <= 0 else entry[0]
