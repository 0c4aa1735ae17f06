"""Reduction of the ``torch.profiler`` trace of a measured window.

``busy_s`` is the union of the intervals in which a kernel, copy or
memset ran on the device, inside the traced window; ``device_ops`` the
device operations with the most time, by name; ``idle_gaps`` the longest
stretches with nothing on the device, each named by the innermost span
the host had open at its middle (``host`` where none was).
"""

from __future__ import annotations

from collections import defaultdict


def _events(prof):
    """(name, is_device, start ns, end ns) of every event the profiler
    kept."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        is_device = str(e.device_type()).split(".")[-1] != "CPU"
        out.append((e.name(), is_device, int(start), int(start + dur)))
    return out


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


WINDOW = "span:window"


def reduce_trace(prof) -> dict:
    """busy_s, window_s and the breakdown of the window the harness marked
    with a ``span:window`` profiler label."""
    events = _events(prof)
    (window_start_ns, window_end_ns), = [(s, e) for n, d, s, e in events if not d and n == WINDOW]
    # the spans' own labels also appear on the device timeline: not work
    device = [(n, max(s, window_start_ns), min(e, window_end_ns)) for n, d, s, e in events
              if d and not n.startswith("span:") and e > window_start_ns and s < window_end_ns]
    by_name = defaultdict(float)
    for name, s, e in device:
        by_name[name] += (e - s) * 1e-9
    busy = _union([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, cursor = [], window_start_ns
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if window_end_ns > cursor:
        gaps.append((cursor, window_end_ns))
    spans = [(s, e, n[len("span:"):]) for n, d, s, e in events
             if not d and n.startswith("span:") and n != WINDOW]
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) // 2
        open_spans = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(open_spans, key=lambda sp: sp[1] - sp[0])[2] if open_spans else "host"
        labelled.append([label, (e - s) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (window_end_ns - window_start_ns) * 1e-9,
        "device_ops": [[name, seconds] for name, seconds in top],
        "idle_gaps": labelled,
    }
