"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the device, from the ``torch.profiler`` trace."""


def install(spans):
    pass


def read(run):
    trace = run["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
