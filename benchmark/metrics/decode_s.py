"""decode_s: seconds a tile spends in ``decode_pixels`` (normalization
optimization, chromatic estimate, final decode, extraction, filter), mean
over the window's tiles."""

SPAN = ("decode", "merfish3d_tpu_torch.cli.simulation.pixeldecode", "decode_pixels")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
