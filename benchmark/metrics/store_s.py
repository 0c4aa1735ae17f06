"""store_s: seconds a tile spends in ``convert_data`` (raw arrays → the
in-memory datastore: clip, upload and PSFs), mean over the window's tiles."""

SPAN = ("store", "merfish3d_tpu_torch.cli.simulation.convert_to_datastore", "convert_data")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
