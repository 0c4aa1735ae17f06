"""predict_s: seconds a tile spends in the spot predictor's
``UFishPredictor.forward`` (normalization, padding and the network over
every plane of a registration batch), synchronized on both sides, so the
card's time and not the host's queueing; mean over the window's tiles."""

SPAN = ("predict", "merfish3d_tpu_torch.models.ufish", "UFishPredictor.forward")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
