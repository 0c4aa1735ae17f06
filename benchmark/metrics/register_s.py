"""register_s: seconds a tile spends in
``DataRegistration.register_all_tiles`` (fiducial registration, flow,
readout RLGC and the spot predictor), mean over the window's tiles."""

SPAN = ("register", "merfish3d_tpu_torch.pipeline.registration", "DataRegistration.register_all_tiles")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
