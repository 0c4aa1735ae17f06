"""decon_ms_per_iter_vol: milliseconds of the registration's RLGC batch
solves (synchronized) over the volume-iterations they ran: the readout
solves, and with fiducial deconvolution the moving rounds' batch solves
too; round 0's single fiducial solve lies outside (:mod:`benchmark.solves`)."""

from benchmark.solves import SPAN, install  # noqa: F401


def read(run):
    span = run["spans"].get(SPAN[0])
    iterations = sum(sum(iters) for _, _, (iters, _) in span.calls)
    return 1e3 * span.total() / iterations if iterations else None
