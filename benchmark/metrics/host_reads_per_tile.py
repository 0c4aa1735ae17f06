"""host_reads_per_tile: blocking device-to-host reads a tile makes, as the
program counts them (``copy.reads``: downloads and scalar and list reads
alike), mean over the window's tiles."""

from benchmark.program_counters import install, per_tile  # noqa: F401


def read(run):
    return per_tile(run, "copy.reads")
