"""Component extraction on tensors: the connected components of a decoded
volume and their sums, where the decode left its outputs.

:func:`label_components` finds the 26-connected components of equal
codeword over the foreground (``decoded >= 0``) and returns them in the
sparse form of the native host labeller (:mod:`merfish3d_tpu_torch.native`,
the tests' oracle): the foreground's linear indices in scan order and each
voxel's root. The root is the component's smallest linear index, so
sorting by root orders the components as the host labeller numbers them.

:func:`component_sums` takes those labels and returns, for the components
within a size window, every sum :func:`..ops.cc.component_stats_host`
forms, as host float64 arrays; that function derives the statistics from
them. Only the window's rows cross to the host.

Each dispatches on the device of its input: a CUDA tensor launches the
kernels of ``csrc/components.cu`` (``label_components_i16``,
``component_sums_f64``), a CPU tensor runs the plain versions here
(:func:`label_volume_plain`, :func:`component_sums_plain`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count, to_host

# the columns of a component's row of sums, before its per-bit sums
GEOMETRY_COLUMNS = (
    "area", "z", "y", "x", "zz", "yy", "xx", "zy", "zx", "yx",
    "magnitude_sum", "distance_min", "codeword",
)

# the 26 neighbour offsets (dz, dy, dx) of a voxel
_OFFSETS = [
    (dz, dy, dx)
    for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    if (dz, dy, dx) != (0, 0, 0)
]


def _check_decoded(decoded: torch.Tensor) -> None:
    if decoded.ndim != 3 or decoded.dtype != torch.int16 or not decoded.is_contiguous():
        raise ValueError(
            f"decoded must be a contiguous (Z, Y, X) int16 tensor, got "
            f"{tuple(decoded.shape)} {decoded.dtype}"
        )
    if decoded.numel() > np.iinfo(np.int32).max:
        raise ValueError("volume too large for int32 labels")


def label_volume_plain(decoded: torch.Tensor) -> torch.Tensor:
    """What ``label_components_i16`` computes, in plain torch: every
    foreground voxel takes the least label among itself and its equal
    26-neighbours, then jumps to its label's label, until nothing
    changes (min-label propagation with pointer jumping, as the JAX
    package's ``label_connected``). Returns the (Z, Y, X) int32 roots,
    -1 on the background."""
    _check_decoded(decoded)
    shape = decoded.shape
    n = decoded.numel()
    fg = decoded >= 0
    sentinel = n
    labels = torch.where(
        fg, torch.arange(n, dtype=torch.int64, device=decoded.device).reshape(shape), sentinel
    )
    dec_p = torch.nn.functional.pad(decoded.to(torch.int32), (1, 1, 1, 1, 1, 1), value=-2)
    nz, ny, nx = shape

    def window(t, off):
        dz, dy, dx = off
        return t[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]

    same = [(window(dec_p, off) == decoded) & fg for off in _OFFSETS]
    while True:
        lab_p = torch.nn.functional.pad(labels, (1, 1, 1, 1, 1, 1), value=sentinel)
        best = labels
        for off, ok in zip(_OFFSETS, same):
            best = torch.minimum(best, torch.where(ok, window(lab_p, off), sentinel))
        flat = best.reshape(-1)
        jumped = torch.where(flat == sentinel, sentinel, flat[flat.clamp(max=n - 1)])
        best = torch.minimum(flat, jumped).reshape(shape)
        if torch.equal(best, labels):
            break
        labels = best
    return torch.where(fg, labels, -1).to(torch.int32)


def label_volume_cuda(decoded: torch.Tensor) -> torch.Tensor:
    """``label_components_i16`` on a CUDA tensor; contract of
    :func:`label_volume_plain`."""
    if decoded.device.type != "cuda":
        raise ValueError("label_volume_cuda needs a CUDA tensor")
    _check_decoded(decoded)
    labels = torch.empty(decoded.shape, dtype=torch.int32, device=decoded.device)
    status = _build.kernels().label_components_i16(
        decoded.data_ptr(), *decoded.shape, labels.data_ptr(),
        _build.stream_handle(decoded.device),
    )
    _build.check(status, "label_components_i16")
    count("launch.label_components_i16")
    return labels


def label_components(decoded: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """26-connected components of equal value over ``decoded >= 0``.
    Returns int64 ``(lin, roots)`` on ``decoded``'s device: each foreground
    voxel's linear index, in scan order, and its component's root (the
    component's smallest linear index)."""
    if decoded.device.type == "cuda":
        labels = label_volume_cuda(decoded)
    elif decoded.device.type == "cpu":
        labels = label_volume_plain(decoded)
    else:
        raise ValueError(f"unsupported device {decoded.device}")
    flat = labels.reshape(-1)
    lin = torch.nonzero(flat >= 0).squeeze(1)
    count("copy.reads")  # nonzero reads its count back
    return lin, flat[lin].to(torch.int64)


def _sum_columns(bits: int, weighted: bool) -> int:
    return len(GEOMETRY_COLUMNS) + bits * (4 if weighted else 1)


def _check_sum_inputs(decoded, magnitude, distance, values) -> None:
    _check_decoded(decoded)
    for name, t in (("magnitude", magnitude), ("distance", distance)):
        if t.shape != decoded.shape or t.dtype != torch.float16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float16 tensor shaped like decoded")
    if (
        values.ndim != 4 or tuple(values.shape[1:]) != tuple(decoded.shape)
        or values.dtype not in (torch.float16, torch.float32)
        or not values[0].is_contiguous()
    ):
        raise ValueError(
            "values must be (bits, Z, Y, X) float16 or float32 with contiguous planes, got "
            f"{tuple(values.shape)} {values.dtype}"
        )
    for name, t in (("magnitude", magnitude), ("distance", distance), ("values", values)):
        if t.device != decoded.device:
            raise ValueError(f"{name} is on {t.device}, decoded on {decoded.device}")


def component_sums_plain(lin, offsets, counts, decoded, magnitude, distance, values, *, weighted):
    """What ``component_sums_f64`` computes, in plain torch: float64
    ``index_add_`` over the components' voxels in their order in ``lin``,
    which on the CPU is the kernel's order (on a card its atomics add in
    any order). Returns the (k, columns) float64 rows."""
    k = counts.numel()
    bits = values.shape[0]
    dev = decoded.device
    out = torch.zeros((k, _sum_columns(bits, weighted)), dtype=torch.float64, device=dev)
    if k == 0:
        return out
    seg = torch.repeat_interleave(torch.arange(k, device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    pos = (
        offsets.repeat_interleave(counts) + torch.arange(seg.numel(), device=dev)
        - start.repeat_interleave(counts)
    )
    vox = lin[pos]
    ny, nx = decoded.shape[1], decoded.shape[2]
    z = torch.div(vox, ny * nx, rounding_mode="floor")
    rem = vox - z * (ny * nx)
    y = torch.div(rem, nx, rounding_mode="floor")
    z, y, x = z.to(torch.float64), y.to(torch.float64), (rem % nx).to(torch.float64)

    def wsum(col: int, w: torch.Tensor) -> None:
        out[:, col].index_add_(0, seg, w)

    for col, w in enumerate(
        (torch.ones_like(z), z, y, x, z * z, y * y, x * x, z * y, z * x, y * x)
    ):
        wsum(col, w)
    wsum(10, magnitude.reshape(-1)[vox].to(torch.float64))
    out[:, 11] = torch.full((k,), float("inf"), dtype=torch.float64, device=dev).scatter_reduce(
        0, seg, distance.reshape(-1)[vox].to(torch.float64), "amin"
    )
    out[:, 12] = decoded.reshape(-1)[lin[offsets]].to(torch.float64)
    flat = values.reshape(bits, -1)
    g = len(GEOMETRY_COLUMNS)
    for b in range(bits):
        w = flat[b, vox].to(torch.float64)
        wsum(g + b, w)
        if weighted:
            for a, c in enumerate((z, y, x)):
                wsum(g + bits + 3 * b + a, w * c)
    return out


def component_sums_cuda(lin, offsets, counts, decoded, magnitude, distance, values, *, weighted):
    """``component_sums_f64`` on CUDA tensors; contract of
    :func:`component_sums_plain`."""
    if decoded.device.type != "cuda":
        raise ValueError("component_sums_cuda needs CUDA tensors")
    k = counts.numel()
    bits = values.shape[0]
    out = torch.empty((k, _sum_columns(bits, weighted)), dtype=torch.float64, device=decoded.device)
    if k == 0:
        return out
    status = _build.kernels().component_sums_f64(
        lin.data_ptr(), offsets.data_ptr(), counts.data_ptr(), k,
        decoded.data_ptr(), magnitude.data_ptr(), distance.data_ptr(), values.data_ptr(),
        int(values.dtype == torch.float16), values.stride(0), bits,
        decoded.shape[1], decoded.shape[2], int(weighted), out.data_ptr(),
        _build.stream_handle(decoded.device),
    )
    _build.check(status, "component_sums_f64")
    count("launch.component_sums_f64")
    return out


def component_segments(
    labels: tuple[torch.Tensor, torch.Tensor],  # label_components' (lin, roots)
    size_window: Optional[tuple[float, float]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The foreground sorted stably by root, so each component's voxels
    are contiguous and in scan order, and the ``(offsets, counts)`` of the
    components whose area lies within ``size_window = (least, most)`` (all
    without one), in root order: the inputs of the sums kernels. Counts the
    components before the window as ``extract.components``."""
    lin, roots = labels
    order = torch.sort(roots, stable=True).indices
    lin_s, roots_s = lin[order], roots[order]
    counts = torch.unique_consecutive(roots_s, return_counts=True)[1]
    count("copy.reads")  # unique_consecutive reads its count back
    count("extract.components", counts.numel())
    offsets = torch.cumsum(counts, 0) - counts
    if size_window is not None:
        least, most = size_window
        kept = torch.nonzero((counts >= least) & (counts <= most)).squeeze(1)
        count("copy.reads")
        offsets, counts = offsets[kept], counts[kept]
    return lin_s, offsets, counts


def component_sums(
    decoded: torch.Tensor,  # (Z, Y, X) int16, -1 background
    labels: tuple[torch.Tensor, torch.Tensor],  # label_components' (lin, roots)
    distance: torch.Tensor,  # (Z, Y, X) float16
    magnitude: torch.Tensor,  # (Z, Y, X) float16
    values: torch.Tensor,  # (bits, Z, Y, X) float16 or float32
    *,
    weighted: bool = False,
    size_window: Optional[tuple[float, float]] = None,
) -> np.ndarray:
    """Every component's sums, in float64 and in scan order within the
    component (the order ``np.bincount`` adds in), for the components whose
    area lies within ``size_window = (least, most)`` (all without one), in
    root order. Returns the host (k, columns) float64 rows: the
    :data:`GEOMETRY_COLUMNS`, ``bits`` intensity sums, then with
    ``weighted`` ``bits`` × (z, y, x) intensity-weighted sums. Counts the
    components before the window as ``extract.components``
    (:func:`component_segments`)."""
    _check_sum_inputs(decoded, magnitude, distance, values)
    lin_s, offsets, counts = component_segments(labels, size_window)
    if decoded.device.type == "cuda":
        sums = component_sums_cuda
    elif decoded.device.type == "cpu":
        sums = component_sums_plain
    else:
        raise ValueError(f"unsupported device {decoded.device}")
    return to_host(sums(lin_s, offsets, counts, decoded, magnitude, distance, values, weighted=weighted))
