"""decon_roofline: the least time of the RLGC batch solves' work
(:func:`benchmark.roofline.rlgc_least_seconds` at each solve's padded
shape and iterations) over their synchronized wall, in percent of the
card's published peak (H100 SXM, 700 W); the solves are those
:mod:`benchmark.solves` names."""

from benchmark.roofline import rlgc_least_seconds
from benchmark.solves import SPAN, install  # noqa: F401


def read(run):
    span = run["spans"].get(SPAN[0])
    if not span.calls:
        return None
    least = sum(rlgc_least_seconds(shape, sum(iters)) for _, _, (iters, shape) in span.calls)
    return 100.0 * least / span.total()
