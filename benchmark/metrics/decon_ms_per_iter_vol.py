"""decon_ms_per_iter_vol: milliseconds of the readout RLGC solves
(synchronized) over the volume-iterations they ran."""

from benchmark.solves import SPAN, install  # noqa: F401


def read(run):
    span = run["spans"].get(SPAN[0])
    iterations = sum(sum(iters) for _, _, (iters, _) in span.calls)
    return 1e3 * span.total() / iterations if iterations else None
