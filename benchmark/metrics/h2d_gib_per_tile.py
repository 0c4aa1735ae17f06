"""h2d_gib_per_tile: GiB a tile copies from the host to the device, as the
program counts them (``copy.h2d_bytes``), mean over the window's tiles."""

from benchmark.program_counters import install, per_tile  # noqa: F401


def read(run):
    return per_tile(run, "copy.h2d_bytes", 2.0**-30)
