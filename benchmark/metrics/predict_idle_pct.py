"""predict_idle_pct: the share of the program's ``ufish.net`` spans (each
network call on a batch of planes) in which the device ran no kernel,
copy or memset, from the ``torch.profiler`` trace of the window."""

from benchmark import program_counters, span_idle


def install(spans):
    program_counters.install(spans)
    span_idle.install()


def read(run):
    return span_idle.idle_pct(run, "ufish.net")
