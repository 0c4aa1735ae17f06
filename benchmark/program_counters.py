"""The program's own tracing registry (``merfish3d_tpu_torch.utils.profiling``),
for the per-layer metrics that read its spans and counters.

A metric's ``install`` turns the registry on for the traced window: the
first to install resets it, and each puts turning it off on the window's
undo list, so tracing runs only under ``--trace 1`` and stops when the
window's wrappers are restored. A program without the registry (an older
commit) has nothing to read: installing does nothing and every reading
is None.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Optional


def registry() -> Optional[ModuleType]:
    try:
        return importlib.import_module("merfish3d_tpu_torch.utils.profiling")
    except ModuleNotFoundError:
        return None


def install(spans) -> None:
    profiling = registry()
    if profiling is None:
        return
    if not profiling.enabled():
        profiling.reset()
        profiling.enable(True)
    spans._restore.append(lambda: profiling.enable(False))


def snapshot() -> Optional[dict]:
    """The registry's sums, or None without a registry."""
    profiling = registry()
    return None if profiling is None else profiling.snapshot()


def total(snap: dict, name: str) -> int:
    """Counter ``name`` over every span; 0 where it never counted."""
    return snap["counters"].get(name, {}).get("total", 0)


def per_tile(run, name: str, scale: float = 1.0) -> Optional[float]:
    """Counter ``name`` over the window's tiles, times ``scale``."""
    snap = snapshot()
    return None if snap is None else scale * total(snap, name) / run["tiles"]
