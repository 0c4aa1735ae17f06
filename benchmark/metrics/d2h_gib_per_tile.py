"""d2h_gib_per_tile: GiB a tile copies from the device to the host, as the
program counts them (``copy.d2h_bytes``: every crossing through its
counting helpers, by the bytes each asks to move), mean over the window's
tiles."""

from benchmark.program_counters import install, per_tile  # noqa: F401


def read(run):
    return per_tile(run, "copy.d2h_bytes", 2.0**-30)
