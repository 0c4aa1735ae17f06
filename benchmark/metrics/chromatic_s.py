"""chromatic_s: seconds a tile spends in the decode's chromatic estimate
(``decoder.estimate_chromatic_affines_from_barcodes``, once a pass), mean
over the window's tiles."""

SPAN = ("chromatic", "merfish3d_tpu_torch.pipeline.decoder", "estimate_chromatic_affines_from_barcodes")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
