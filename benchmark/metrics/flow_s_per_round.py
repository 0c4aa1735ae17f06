"""flow_s_per_round: seconds of one moving round's deformable flow
estimate (``estimate_sofima_flow_field_xyz_px`` as the registration
calls it), mean over the window's calls."""

SPAN = ("flow", "merfish3d_tpu_torch.pipeline.registration", "estimate_sofima_flow_field_xyz_px")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / len(span.calls) if span.calls else None
