"""Spans and counters of the port: where a tile's host time goes, what
crosses between host and device, and how often each kernel launches.

Tracing is off by default; :func:`enable` turns it on. Off, a span, a
counter and a counted crossing each cost one check of a module flag and
allocate nothing.

On, a :func:`span` records its name, its start and end, its parent (the
innermost span open when it opened) and a run id, which the entry-point
spans take from the :class:`~..datastore.array_store.ArrayStore` they
work on and every child span inherits. A span also opens
``torch.profiler.record_function("span:" + name)``, so it shows on a
profiler timeline. Its times are ``time.time_ns()``, the clock the
profiler's events carry, so a span and its ``span:`` event agree at both
ends. A span never synchronizes the device: it times the host.

Counters (:func:`count`) are attributed to the innermost open span. The
crossing helpers :func:`to_host`, :func:`read_scalar`, :func:`read_list`
and :func:`to_device` count ``copy.d2h_bytes``, ``copy.h2d_bytes`` and
``copy.reads`` (every blocking device→host read) by the bytes the call
asks to move, whatever the tensor's device, so a CPU run counts what a
card run would. They keep no reference to a tensor. The kernels' wrappers
count ``launch.<kernel>``.

Everything stays in memory until :func:`reset`: :func:`snapshot` sums it
by name, :func:`records` gives the raw spans. The port runs a tile on one
thread, and the registry assumes so.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

_on = False
_records: list["Record"] = []
_stack: list[int] = []  # indices in _records of the open spans, outermost first
_counts: dict[tuple[str, str], int] = defaultdict(int)


class Record:
    """One span: name, start and end (ns, ``time.time_ns``), the index of
    its parent in :func:`records` (None at the top) and its run id."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "run")

    def __init__(self, name: str, run):
        self.name, self.run = name, run
        self.start_ns = self.end_ns = self.parent = None


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter; spans open now stay recorded."""
    open_spans = [_records[i] for i in _stack]
    _records[:] = open_spans
    _counts.clear()
    for i, rec in enumerate(open_spans):
        rec.parent = i - 1 if i else None
    _stack[:] = range(len(open_spans))


class _Span:
    __slots__ = ("rec", "label")

    def __init__(self, name: str, run):
        self.rec = Record(name, run)
        self.label = torch.profiler.record_function("span:" + name)

    def __enter__(self):
        rec = self.rec
        if _stack:
            rec.parent = _stack[-1]
            if rec.run is None:
                rec.run = _records[rec.parent].run
        self.label.__enter__()
        rec.start_ns = time.time_ns()
        _stack.append(len(_records))
        _records.append(rec)
        return self

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        _stack.pop()
        self.label.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()  # reusable: the off path allocates nothing


def span(name: str, run=None):
    """Context manager: one span of ``name``; ``run`` sets the run id of an
    entry-point span (children inherit their parent's)."""
    if not _on:
        return _OFF
    return _Span(name, run)


def set_run(run) -> None:
    """Give the innermost open span, and the spans recorded inside it so
    far, the run id ``run``: an entry point that creates the store its
    run is named after learns the id only once it has made it."""
    if not _on or not _stack:
        return
    for rec in _records[_stack[-1]:]:
        if rec.run is None:
            rec.run = run


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under the innermost open span."""
    if not _on:
        return
    _counts[(name, _records[_stack[-1]].name if _stack else "")] += int(n)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array: one blocking read of its bytes."""
    if _on:
        count("copy.d2h_bytes", _nbytes(t))
        count("copy.reads")
    return t.cpu().numpy()


def read_scalar(t: torch.Tensor):
    """The one value of ``t`` as a Python number: one blocking read."""
    if _on:
        count("copy.d2h_bytes", t.element_size())
        count("copy.reads")
    return t.item()


def read_list(t: torch.Tensor) -> list:
    """``t.tolist()``: one blocking read of its bytes."""
    if _on:
        count("copy.d2h_bytes", _nbytes(t))
        count("copy.reads")
    return t.tolist()


def to_device(a, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)``, counted as an upload of the
    result's bytes."""
    t = torch.as_tensor(a, device=device)
    if _on:
        count("copy.h2d_bytes", _nbytes(t))
    return t


def records() -> list[Record]:
    """The raw spans, in the order they opened."""
    return list(_records)


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "seconds", "self_seconds"}},
    "counters": {name: {"total", "by_span": {span name: n}}}}``. A span's
    self seconds are its duration less its child spans' (a span still
    open counts to now). Counts outside every span sit under ``""``."""
    now = time.time_ns()
    dur = [((r.end_ns if r.end_ns is not None else now) - r.start_ns) * 1e-9 for r in _records]
    child = [0.0] * len(_records)
    for i, r in enumerate(_records):
        if r.parent is not None:
            child[r.parent] += dur[i]
    spans: dict = {}
    for i, r in enumerate(_records):
        s = spans.setdefault(r.name, {"calls": 0, "seconds": 0.0, "self_seconds": 0.0})
        s["calls"] += 1
        s["seconds"] += dur[i]
        s["self_seconds"] += dur[i] - child[i]
    counters: dict = {}
    for (name, where), v in sorted(_counts.items()):
        c = counters.setdefault(name, {"total": 0, "by_span": {}})
        c["total"] += v
        c["by_span"][where] = v
    return {"spans": spans, "counters": counters}
