"""warp_s: seconds a tile spends warping its bit stack into the reference
round's frame (``decode_warping.warp_bit_images_to_reference``, every
call of the decode), mean over the window's tiles."""

SPAN = ("warp", "merfish3d_tpu_torch.pipeline.decode_warping", "warp_bit_images_to_reference")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
