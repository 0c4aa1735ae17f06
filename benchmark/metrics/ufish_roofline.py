"""ufish_roofline: the U-FISH network's least time
(:func:`benchmark.ufish_work.least_seconds`, the convolutions of the
topology and padded plane of each ``UFishNet.forward`` call) for the
planes the program's ``ufish.planes`` counter counted, over the device's
wall under the program's ``ufish.net`` spans in the traced window
(:mod:`benchmark.device_spans`), in percent. Zero planes that pad a last
batch are work the network does but no plane needs: they count in the
wall and not in the least time.

Each call's topology and input shape are recorded by a wrapper that
neither synchronizes nor labels anything, so the device runs under
``ufish.net`` as it does untraced."""

from benchmark import device_spans, program_counters
from benchmark.ufish_work import least_seconds

MODULE, CLASS = "merfish3d_tpu_torch.models.ufish", "UFishNet"
CALLS = "ufish_calls"


def install(spans):
    import importlib

    program_counters.install(spans)
    device_spans.install()
    calls = spans.get(CALLS).calls
    net = getattr(importlib.import_module(MODULE), CLASS, None)
    if net is None:
        return
    inner = net.forward

    def forward(self, x):
        spec = {"base_features": self.base_features, "depths": list(self.depths), "up_mode": self.up_mode}
        calls.append((0.0, 0.0, (spec, tuple(x.shape[:3]))))
        return inner(self, x)

    net.forward = forward
    spans._restore.append(lambda: setattr(net, "forward", inner))


def read(run):
    calls = run["spans"].get(CALLS).calls
    wall = device_spans.wall_s(run, "ufish.net")
    snap = program_counters.snapshot()
    planes = 0 if snap is None else program_counters.total(snap, "ufish.planes")
    if not calls or not planes or wall is None:
        return None
    batched = sum(shape[0] for _, _, (_, shape) in calls)
    least = sum(least_seconds(spec, *shape) for _, _, (spec, shape) in calls) * planes / batched
    return 100.0 * least / wall
