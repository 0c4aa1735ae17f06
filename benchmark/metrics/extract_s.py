"""extract_s: seconds a tile spends in the host's component statistics
(``decoder.component_stats_host``, once a decode pass), mean over the
window's tiles."""

SPAN = ("extract", "merfish3d_tpu_torch.pipeline.decoder", "component_stats_host")


def install(spans):
    spans.wrap(*SPAN)


def read(run):
    span = run["spans"].get(SPAN[0])
    return span.total() / run["tiles"] if span.calls else None
