"""Synchronized spans around calls into the program.

A span wraps one attribute of one of the program's modules (a function,
or a method as ``Class.method``), as the calling module looks it up, so
every call through the normal path is recorded: host-clock start and end
with the device synchronized on both sides, under a profiler label of the
span's name. A metric that needs a span asks for it by name; the first
request installs the wrapper. An attribute the program no longer has is
reported on standard error and its span stays empty, so its metrics read
nothing.
"""

from __future__ import annotations

import importlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch


@dataclass
class Span:
    name: str
    calls: list = field(default_factory=list)  # (start s, end s, extra)
    installed: bool = False

    def total(self) -> float:
        return sum(end - start for start, end, _ in self.calls)


class Spans:
    """The spans of one run, and the wrappers that feed them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.spans: dict[str, Span] = {}
        self._restore: list[Callable[[], None]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get(self, name: str) -> Span:
        return self.spans.setdefault(name, Span(name))

    def wrap(self, name: str, module: str, attr: str,
             call: Optional[Callable] = None) -> Span:
        """Record every call of ``module.attr`` under span ``name``.
        ``call(inner, args, kwargs) -> (result, extra)`` replaces the plain
        call where a span needs more than the wall (iteration counts)."""
        span = self.get(name)
        if span.installed:
            return span
        owner = importlib.import_module(module)
        *path, leaf = attr.split(".")
        try:
            for part in path:
                owner = getattr(owner, part)
            inner = getattr(owner, leaf)
        except AttributeError:
            print(f"span {name}: {module}.{attr} is missing; its metrics read nothing", file=sys.stderr)
            return span
        spans = self

        def wrapper(*args, **kwargs):
            spans._sync()
            with torch.profiler.record_function(f"span:{name}"):
                start = time.perf_counter()
                if call is None:
                    result, extra = inner(*args, **kwargs), None
                else:
                    result, extra = call(inner, args, kwargs)
                spans._sync()
                end = time.perf_counter()
            span.calls.append((start, end, extra))
            return result

        setattr(owner, leaf, wrapper)
        self._restore.append(lambda: setattr(owner, leaf, inner))
        span.installed = True
        return span

    def restore(self) -> None:
        for undo in reversed(self._restore):
            undo()
        self._restore.clear()
