"""launches_per_tile: launches of the program's own kernels (K1-K11, the
``launch.<kernel>`` counters of its wrappers) in a tile, mean over the
window's tiles. ATen's launches are not among them: the profiler has
those."""

from benchmark.program_counters import install, snapshot  # noqa: F401


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    launches = sum(c["total"] for name, c in snap["counters"].items() if name.startswith("launch."))
    return launches / run["tiles"]
