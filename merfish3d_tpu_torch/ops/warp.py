"""Affine and affine + flow volume warps (counterpart of
``merfish3d_tpu/ops/warp.py``): ``transform_to_pixel``, the three affine
warp classes (``translate_volume``, ``separable_diagonal_resample`` and
the trilinear ``_affine_warp_core``), ``warp_affine``, the composed
affine + flow warp ``warp_affine_plus_flow`` (the separable roll-blend
``_flow_warp_separable_core`` or the gather ``_affine_flow_warp_core``),
the batched forms and ``transform_points_to_reference``.

Physical-transform convention as the reference's: the 4x4
``transform_zyx_um`` maps output/reference physical coordinates to
input/moving ones, with ``matrix_px = (A * s_row) / s_col`` and
``offset_px = (A @ origin + t - origin) / s``.

Every warp is order-1 ``map_coordinates`` in ``constant`` mode, as JAX
computes it: ``lower = floor(c)``, weights ``1 - (c - lower)`` and
``c - lower``; a corner takes ``cval`` unless every one of its indices
lies in ``[0, size)``; the weight product is taken z·y·x and the corners
are summed in ``itertools.product`` order. Sample coordinates are
per-axis multiply-adds in float32, never a matrix product (the reference
records multi-pixel errors from reduced-precision coordinate products,
``docs/kernels.md``), and not ``grid_sample``, whose normalized
coordinates round positions differently. A flow field is interpolated
in ``nearest`` mode, which clamps each node index (not the coordinate)
and takes every node as valid. The warps take and return tensors on the
input's device.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..utils.profiling import to_device, to_host
from .device import as_device_tensor


def transform_to_pixel(
    transform_zyx_um: np.ndarray,
    spacing_zyx_um,
    origin_zyx_um=(0.0, 0.0, 0.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a physical 4x4 (reference → moving) to pixel matrix + offset."""
    transform = np.asarray(transform_zyx_um, dtype=np.float32)
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    origin = np.asarray(origin_zyx_um, dtype=np.float32)
    linear = transform[:3, :3]
    translation = transform[:3, 3]
    matrix_px = (linear * spacing[np.newaxis, :]) / spacing[:, np.newaxis]
    offset_px = (linear @ origin + translation - origin) / spacing
    return matrix_px, offset_px


def translate_volume(vol: torch.Tensor, shift_pull_px, cval: float = 0.0) -> torch.Tensor:
    """Sub-pixel translation ``out[p] = vol[p + shift]`` (pull shift),
    ``cval`` outside: per axis one linear blend of two shifted copies,
    exactly order-1 ``map_coordinates`` in constant mode. ``shift_pull_px``
    may be a tensor on the volume's device; nothing is read back to the
    host."""
    out = vol.to(torch.float32)
    shift = as_device_tensor(shift_pull_px, vol.device).to(torch.float32)
    for ax in range(vol.ndim):
        n = vol.shape[ax]
        s = shift[ax]
        i = torch.floor(s)
        f = s - i
        pos = torch.arange(n, device=vol.device) + i.to(torch.int64)
        shape = [1] * vol.ndim
        shape[ax] = n
        valid_a = ((pos >= 0) & (pos <= n - 1)).reshape(shape)
        valid_b = ((pos + 1 >= 0) & (pos + 1 <= n - 1)).reshape(shape)
        a = out.index_select(ax, pos.clamp(0, n - 1))
        b = out.index_select(ax, (pos + 1).clamp(0, n - 1))
        out = (1.0 - f) * torch.where(valid_a, a, cval) + f * torch.where(valid_b, b, cval)
    return out


def separable_diagonal_resample(vol: torch.Tensor, scale, offset_px, cval: float = 0.0) -> torch.Tensor:
    """Trilinear resample under a diagonal pixel affine,
    ``out[p] = vol[scale ⊙ p + offset]``: tensor-product linear
    interpolation is separable, so three 1-D resamples (two gathers and a
    blend an axis) replace the 3-D gather. Each axis's source positions
    ``scale · p + offset`` are rounded once to float32, as the fused
    multiply-add that XLA contracts the reference's expression to."""
    out = vol.to(torch.float32)
    scale = np.asarray(scale, np.float32).astype(np.float64)
    offset = np.asarray(offset_px, np.float32).astype(np.float64)
    for ax in range(vol.ndim):
        n = out.shape[ax]
        pos = torch.arange(n, dtype=torch.float64, device=vol.device)
        src = (float(scale[ax]) * pos + float(offset[ax])).to(torch.float32)
        i0r = torch.floor(src).to(torch.int64)
        f = src - i0r.to(torch.float32)
        shape = [1] * vol.ndim
        shape[ax] = n
        fb = f.reshape(shape)
        va = ((i0r >= 0) & (i0r <= n - 1)).reshape(shape)
        vb = ((i0r + 1 >= 0) & (i0r + 1 <= n - 1)).reshape(shape)
        a = out.index_select(ax, i0r.clamp(0, n - 1))
        b = out.index_select(ax, (i0r + 1).clamp(0, n - 1))
        out = (1.0 - fb) * torch.where(va, a, cval) + fb * torch.where(vb, b, cval)
    return out


def _interp_nodes(coord: torch.Tensor, size: int, order: int, mode: str = "constant"):
    """JAX's per-axis (index, valid, weight) nodes of order 0 or 1; weight
    None is the unit weight of order 0. ``constant`` mode marks a node
    outside ``[0, size)`` invalid; ``nearest`` clamps its index and keeps
    it (valid None)."""
    if order == 1:
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        nodes = [(idx, 1.0 - upper_w), (idx + 1, upper_w)]
    elif order == 0:
        # round half away from zero, as lax.round (torch.round is half to even)
        whole = torch.trunc(coord)
        idx = whole + torch.sign(coord) * ((coord - whole).abs() >= 0.5)
        nodes = [(idx.to(torch.int64), None)]
    else:
        raise NotImplementedError("map_coordinates takes order 0 or 1")
    if mode == "nearest":
        return [(i.clamp(0, size - 1), None, w) for i, w in nodes]
    if mode != "constant":
        raise NotImplementedError("map_coordinates takes mode 'constant' or 'nearest'")
    return [(i.clamp(0, size - 1), (i >= 0) & (i < size), w) for i, w in nodes]


def _map_coordinates(vol: torch.Tensor, coords, *, order: int = 1, mode: str = "constant",
                     cval: float = 0.0) -> torch.Tensor:
    """JAX's ``map_coordinates`` of a 3-D volume at three broadcastable
    coordinate tensors: corners in ``itertools.product`` order, each
    weighted z·y·x and summed left to right."""
    sz, sy, sx = vol.shape
    flat = vol.reshape(-1)
    nodes = [_interp_nodes(c, size, order, mode) for c, size in zip(coords, (sz, sy, sx))]
    acc = None
    for (iz, vz, wz), (iy, vy, wy), (ix, vx, wx) in itertools.product(*nodes):
        corner = flat[(iz * sy + iy) * sx + ix]
        if vz is not None:
            corner = torch.where(vz & vy & vx, corner, cval)
        if wz is not None:
            corner = wz * wy * wx * corner
        acc = corner if acc is None else acc + corner
    return acc


def _affine_warp_core(
    image: torch.Tensor,
    matrix_px,
    offset_px,
    *,
    reference_shape: tuple[int, int, int],
    order: int = 1,
    z_chunk: int = 8,
    cval: float = 0.0,
) -> torch.Tensor:
    """General affine: ``out[p] = image[M p + o]`` by order-0/1
    ``map_coordinates`` in constant mode, ``z_chunk`` output planes at a
    time so the per-corner index tensors stay bounded."""
    nz, ny, nx = reference_shape
    dev = image.device
    img = image.to(torch.float32)
    m = np.asarray(matrix_px, np.float32)
    o = np.asarray(offset_px, np.float32)
    yy = torch.arange(ny, dtype=torch.float32, device=dev).reshape(1, ny, 1)
    xx = torch.arange(nx, dtype=torch.float32, device=dev).reshape(1, 1, nx)
    out = torch.empty((nz, ny, nx), dtype=torch.float32, device=dev)
    for z0 in range(0, nz, z_chunk):
        zc = torch.arange(z0, min(z0 + z_chunk, nz), dtype=torch.float32, device=dev).reshape(-1, 1, 1)
        # explicit per-axis multiply-adds, left to right as the reference
        # writes them; a matrix product could round the coordinates
        src = [
            float(m[a, 0]) * zc + float(m[a, 1]) * yy + float(m[a, 2]) * xx + float(o[a])
            for a in range(3)
        ]
        out[z0: z0 + zc.shape[0]] = _map_coordinates(img, src, order=order, cval=cval)
    return out


def _warp_class(matrix_px: np.ndarray) -> str:
    """The reference's split: diagonal within 1e-8, and then a unit
    diagonal within 1e-6 is a translation."""
    if not np.allclose(matrix_px, np.diag(np.diag(matrix_px)), atol=1e-8):
        return "general"
    return "translate" if np.allclose(np.diag(matrix_px), 1.0, atol=1e-6) else "diagonal"


def _warp_one(image, kind, matrix_px, offset_px, reference_shape, *, order=1, z_chunk=8, cval=0.0):
    if kind == "translate":
        return translate_volume(image, to_device(offset_px, image.device), cval=cval)
    if kind == "diagonal":
        return separable_diagonal_resample(image, np.diag(matrix_px).copy(), offset_px, cval=cval)
    return _affine_warp_core(image, matrix_px, offset_px, reference_shape=reference_shape,
                             order=order, z_chunk=z_chunk, cval=cval)


def warp_affine(
    image,
    *,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    cval: float = 0.0,
    order: int = 1,
    z_chunk: int = 8,
    device=None,
) -> torch.Tensor:
    """Warp ``image`` onto the reference grid under a physical 4x4 affine:
    a translation (``order == 1``, equal shapes, a unit diagonal matrix)
    by ``translate_volume``, a diagonal matrix by
    ``separable_diagonal_resample``, anything else by the trilinear
    ``_affine_warp_core``. A tensor stays on its device; anything else
    goes to ``device`` (the card by default)."""
    img = as_device_tensor(image, device).to(torch.float32)
    matrix_px, offset_px = transform_to_pixel(transform_zyx_um, spacing_zyx_um, reference_origin_zyx_um)
    ref_shape = tuple(int(v) for v in reference_shape)
    kind = "general"
    if order == 1 and ref_shape == tuple(img.shape):
        kind = _warp_class(matrix_px)
    return _warp_one(img, kind, matrix_px, offset_px, ref_shape, order=order, z_chunk=z_chunk,
                     cval=float(cval))


def _sub_batches(n_items: int, item_bytes: int, hbm_budget_bytes: int, live_per_item: int = 3):
    """Yield (start, stop) covering range(n_items) with <= budget live
    bytes per dispatch, ``live_per_item`` item-sized buffers each."""
    max_b = max(1, int(hbm_budget_bytes // max(1, live_per_item * item_bytes)))
    for s in range(0, n_items, max_b):
        yield s, min(n_items, s + max_b)


def _affine_batch_classes(transforms_zyx_um, spacing_zyx_um, n: int):
    """Pixel matrices/offsets of a batch plus its translate / diagonal /
    general class split."""
    mats = np.empty((n, 3, 3), np.float32)
    offs = np.empty((n, 3), np.float32)
    for i in range(n):
        mats[i], offs[i] = transform_to_pixel(transforms_zyx_um[i], spacing_zyx_um)
    kinds = np.asarray([_warp_class(m) for m in mats])
    classes = tuple((np.flatnonzero(kinds == k), k) for k in ("translate", "diagonal", "general"))
    return mats, offs, classes


def warp_affine_batch_device(images, transforms_zyx_um, spacing_zyx_um, *, device=None) -> torch.Tensor:
    """(B, z, y, x) same-shape affine warps on the device, device in and
    device out: numerics identical to per-item :func:`warp_affine`, the
    batch split by warp class. The decoder feeds the result straight into
    its decode."""
    images = as_device_tensor(images, device).to(torch.float32)
    mats, offs, classes = _affine_batch_classes(transforms_zyx_um, spacing_zyx_um, images.shape[0])
    out = torch.empty_like(images)
    for idx, kind in classes:
        for i in idx:
            out[i] = _warp_one(images[i], kind, mats[i], offs[i], tuple(images.shape[1:]))
    return out


def warp_affine_batch(
    images: np.ndarray,
    transforms_zyx_um: np.ndarray,
    spacing_zyx_um,
    *,
    hbm_budget_bytes: int = 12 << 30,
    device="cuda",
) -> np.ndarray:
    """Host in, host out: each warp class uploaded to ``device`` in
    sub-batches within ``hbm_budget_bytes``, warped as
    :func:`warp_affine_batch_device` does, and read back."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    out = np.empty_like(images)
    mats, offs, classes = _affine_batch_classes(transforms_zyx_um, spacing_zyx_um, images.shape[0])
    for idx, kind in classes:
        live = 3 if kind == "general" else 5
        for s, e in _sub_batches(idx.size, images[0].nbytes, hbm_budget_bytes, live_per_item=live):
            sel = idx[s:e]
            batch = to_device(images[sel], device)
            for j, i in enumerate(sel):
                out[i] = to_host(_warp_one(batch[j], kind, mats[i], offs[i], images.shape[1:]))
    return out


# ------------------------------------------------------------ affine + flow
# total roll terms over the three axes above which the separable flow warp
# gives way to the gather (each term is a few full-volume passes)
_SEPARABLE_FLOW_MAX_TERMS = 160

# device bytes one group of the batched separable flow warp may hold; each
# item keeps ~8 volume-sized float32 buffers live (input, output
# accumulator, upsampled flow, shift field, hat weight, shifted copy and
# product). Sized for an 80 GB card beside the decode's own stack; tests
# shrink it to force the grouped path
_FLOW_WARP_BUDGET_BYTES = 24 << 30
_FLOW_WARP_LIVE_PER_ITEM = 8


def _div(x: torch.Tensor, value) -> torch.Tensor:
    """``x / value`` as a true float32 division on every device: CUDA
    turns a division by a host scalar into a product with its reciprocal,
    which can round one bit apart, so the divisor goes as a device
    tensor."""
    return x / to_device(np.float32(value), x.device)


def _upsample_flow_channel(ch: torch.Tensor, *, out_shape, stride_zyx, box_start_zyx) -> torch.Tensor:
    """One lattice flow channel on the full voxel grid: order-1
    ``map_coordinates`` in ``nearest`` mode under a diagonal lattice map,
    as three 1-D takes. ``stride_zyx`` and ``box_start_zyx`` are float32
    values."""
    out = ch.to(torch.float32)
    for ax in range(3):
        n = int(out_shape[ax])
        m = out.shape[ax]
        pos = torch.arange(n, dtype=torch.float32, device=out.device)
        src = torch.clamp(_div(pos - float(box_start_zyx[ax]), stride_zyx[ax]), 0.0, float(m - 1))
        i0 = torch.floor(src).to(torch.int64)
        f = src - i0.to(torch.float32)
        i1 = torch.clamp(i0 + 1, max=m - 1)
        a = out.index_select(ax, i0)
        b = out.index_select(ax, i1)
        shape = [1, 1, 1]
        shape[ax] = n
        fb = f.reshape(shape)
        out = (1.0 - fb) * a + fb * b
    return out


def _shifted(vol: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """``vol[p + k]`` along ``axis``, 0 where ``p + k`` leaves the axis:
    ``roll(vol, -k)`` with the wrapped part zeroed."""
    n = vol.shape[axis]
    out = torch.zeros_like(vol)
    if abs(k) < n:
        out.narrow(axis, max(-k, 0), n - abs(k)).copy_(vol.narrow(axis, max(k, 0), n - abs(k)))
    return out


def _variable_shift_axis(vol: torch.Tensor, shift: torch.Tensor, axis: int, k0: int, k1: int) -> torch.Tensor:
    """1-D linear resample with a per-voxel source shift along ``axis``,
    ``out[p] = lerp(vol, p_axis + shift[p])`` with zero edges: ``shift``
    lies in ``[k0, k1)``, so the terms k0..k1, weighted by the hat
    ``max(0, 1 - |shift - k|)``, are summed in that order."""
    acc = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    for k in range(k0, k1 + 1):
        w = torch.clamp(1.0 - torch.abs(shift - float(k)), min=0.0)
        acc = acc + w * _shifted(vol, k, axis)
    return acc


def _flow_warp_separable_core(images, flows_xyz, scales, offsets_px, strides_zyx, box_starts_zyx, *,
                              k_ranges, out_shape) -> torch.Tensor:
    """Separable composed diagonal-affine + flow warp of a (B, z, y, x)
    batch: per axis z, y, x (flow channels 2, 1, 0) the per-voxel shift
    ``s = (m - 1)·pos + off + m·d`` and one variable-shift resample.
    ``scales``, ``offsets_px``, ``strides_zyx`` and ``box_starts_zyx``
    are (B, 3) float32 numpy arrays; ``k_ranges`` the batch's shared
    per-axis roll ranges. Exact for constant flows; a varying flow is
    evaluated at rows the earlier axes already displaced, as the
    reference's factorization does."""
    out = images.to(torch.float32)
    dev = out.device
    # (3, B, 3): m - 1, offset and m of each item and axis, in float32
    params = to_device(np.stack([scales - np.float32(1.0), offsets_px, scales]).astype(np.float32), dev)
    for ax, ch in ((0, 2), (1, 1), (2, 0)):
        d = torch.stack([
            _upsample_flow_channel(flows_xyz[i, ch], out_shape=out_shape, stride_zyx=strides_zyx[i],
                                   box_start_zyx=box_starts_zyx[i])
            for i in range(out.shape[0])
        ])
        shape = [1, 1, 1, 1]
        shape[ax + 1] = int(out_shape[ax])
        pos = torch.arange(int(out_shape[ax]), dtype=torch.float32, device=dev).reshape(shape)
        m_minus_1, offset, m = (params[k, :, ax].reshape(-1, 1, 1, 1) for k in range(3))
        s = m_minus_1 * pos + offset + m * d
        del d
        out = _variable_shift_axis(out, s, ax + 1, *k_ranges[ax])
    return out


def _separable_flow_bounds(matrix_px, offset_px, flow_xyz, reference_shape):
    """Per-axis roll ranges ``((k0, k1), ...)`` of the separable flow warp
    in float64 on the host, or None where it does not apply: a matrix
    that is not diagonal within 1e-8, a flow that is not finite, or more
    than ``_SEPARABLE_FLOW_MAX_TERMS`` terms."""
    if not np.allclose(matrix_px, np.diag(np.diag(matrix_px)), atol=1e-8):
        return None
    if not np.all(np.isfinite(flow_xyz)):
        return None
    scale = np.diag(matrix_px).astype(np.float64)
    ranges = []
    total = 0
    for ax, ch in ((0, 2), (1, 1), (2, 0)):
        n = float(reference_shape[ax]) - 1.0
        m = scale[ax]
        dmin = float(flow_xyz[ch].min())
        dmax = float(flow_xyz[ch].max())
        lin = [(m - 1.0) * 0.0, (m - 1.0) * n]
        dd = [m * dmin, m * dmax]
        smin = min(lin) + min(dd) + float(offset_px[ax])
        smax = max(lin) + max(dd) + float(offset_px[ax])
        k0 = int(np.floor(smin))
        k1 = int(np.floor(smax)) + 1
        ranges.append((k0, k1))
        total += k1 - k0 + 1
    if total > _SEPARABLE_FLOW_MAX_TERMS:
        return None
    return tuple(ranges)


def _affine_flow_warp_core(image, flow_xyz, matrix_px, offset_px, stride_zyx, box_start_zyx, *,
                           reference_shape, z_chunk: int = 4) -> torch.Tensor:
    """Single-resample composed warp, ``z_chunk`` output planes at a time:
    the flow interpolated at each reference voxel (order 1, ``nearest``),
    the voxel displaced by it, the pixel affine applied as per-axis
    float32 multiply-adds, and the native image sampled once (order 1,
    constant 0)."""
    nz, ny, nx = (int(v) for v in reference_shape)
    dev = image.device
    img = image.to(torch.float32)
    flow = flow_xyz.to(torch.float32)
    m = np.asarray(matrix_px, np.float32)
    o = np.asarray(offset_px, np.float32)
    st = np.asarray(stride_zyx, np.float32)
    bs = np.asarray(box_start_zyx, np.float32)
    yy = torch.arange(ny, dtype=torch.float32, device=dev).reshape(1, ny, 1)
    xx = torch.arange(nx, dtype=torch.float32, device=dev).reshape(1, 1, nx)
    fy = _div(yy - float(bs[1]), st[1])
    fx = _div(xx - float(bs[2]), st[2])
    out = torch.empty((nz, ny, nx), dtype=torch.float32, device=dev)
    for z0 in range(0, nz, z_chunk):
        zc = torch.arange(z0, min(z0 + z_chunk, nz), dtype=torch.float32, device=dev).reshape(-1, 1, 1)
        lattice = [_div(zc - float(bs[0]), st[0]), fy, fx]
        dx, dy, dz = (_map_coordinates(flow[c], lattice, mode="nearest") for c in range(3))
        zd, yd, xd = zc + dz, yy + dy, xx + dx
        src = [
            float(m[a, 0]) * zd + float(m[a, 1]) * yd + float(m[a, 2]) * xd + float(o[a])
            for a in range(3)
        ]
        out[z0: z0 + zc.shape[0]] = _map_coordinates(img, src)
    return out


def _flow_batch_plan(transforms_zyx_um, spacing_zyx_um, flows_np, out_shape):
    """Pixel matrices and offsets of a flow batch, and its shared roll
    ranges: the union of every item's separable bounds, or None when an
    item has none or the union exceeds the term cap."""
    n = flows_np.shape[0]
    mats = np.empty((n, 3, 3), np.float32)
    offs = np.empty((n, 3), np.float32)
    for i in range(n):
        mats[i], offs[i] = transform_to_pixel(transforms_zyx_um[i], spacing_zyx_um)
    per_item = [_separable_flow_bounds(mats[i], offs[i], flows_np[i], out_shape) for i in range(n)]
    if any(r is None for r in per_item):
        return mats, offs, None
    merged = tuple(
        (min(r[ax][0] for r in per_item), max(r[ax][1] for r in per_item)) for ax in range(3)
    )
    if sum(k1 - k0 + 1 for k0, k1 in merged) > _SEPARABLE_FLOW_MAX_TERMS:
        return mats, offs, None
    return mats, offs, merged


def warp_affine_plus_flow(
    image,
    flow_xyz,
    *,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    map_stride_zyx_px,
    map_box_start_xyz_px,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    z_chunk: int = 4,
    method: str = "auto",
    device=None,
) -> torch.Tensor:
    """Composed affine + flow warp with a single resample of the native
    image. ``flow_xyz`` is (3, fz, fy, fx), channels X, Y, Z, in reference
    px on the lattice of ``map_stride_zyx_px`` from
    ``map_box_start_xyz_px``. ``method``: ``"auto"`` takes the separable
    roll-blend path where the shapes match and the bounds admit it, else
    the gather; ``"separable"`` and ``"gather"`` force one. A tensor stays
    on its device; anything else goes to ``device`` (the card by
    default)."""
    img = as_device_tensor(image, device).to(torch.float32)
    matrix_px, offset_px = transform_to_pixel(transform_zyx_um, spacing_zyx_um, reference_origin_zyx_um)
    box_start_zyx = np.asarray(map_box_start_xyz_px, np.float32)[::-1].copy()
    stride = np.asarray(map_stride_zyx_px, np.float32)
    ref_shape = tuple(int(v) for v in reference_shape)
    flow_np = np.asarray(to_host(flow_xyz) if isinstance(flow_xyz, torch.Tensor) else flow_xyz, np.float32)
    flow = to_device(flow_np, img.device)
    if method != "gather" and tuple(img.shape) == ref_shape:
        k_ranges = _separable_flow_bounds(matrix_px, offset_px, flow_np, ref_shape)
        if k_ranges is not None:
            return _flow_warp_separable_core(
                img[None], flow[None], np.diag(matrix_px)[None].astype(np.float32), offset_px[None],
                stride[None], box_start_zyx[None], k_ranges=k_ranges, out_shape=ref_shape,
            )[0]
    if method == "separable":
        raise ValueError(
            "separable flow warp requires a diagonal pixel affine, image.shape == reference_shape, "
            "and bounded flow"
        )
    return _affine_flow_warp_core(img, flow, matrix_px, offset_px, stride, box_start_zyx,
                                  reference_shape=ref_shape, z_chunk=z_chunk)


def warp_affine_plus_flow_batch_device(
    images,
    flows_xyz,
    transforms_zyx_um,
    spacing_zyx_um,
    map_strides_zyx_px,
    map_box_starts_xyz_px,
    *,
    z_chunk: int = 4,
    device=None,
) -> torch.Tensor:
    """(B, z, y, x) composed affine + flow warps, device in and device
    out, each item as :func:`warp_affine_plus_flow` warps it: the
    separable path over the batch's merged roll ranges when every item
    admits it (in groups of at most ``_FLOW_WARP_BUDGET_BYTES`` live
    bytes; the grouping does not change a value), else the gather for
    every item."""
    images = as_device_tensor(images, device).to(torch.float32)
    out_shape = tuple(int(v) for v in images.shape[1:])
    flows_np = np.asarray(flows_xyz, np.float32)
    strides = np.asarray(map_strides_zyx_px, np.float32)
    box_zyx = np.asarray(map_box_starts_xyz_px, np.float32)[:, ::-1].copy()
    mats, offs, k_ranges = _flow_batch_plan(transforms_zyx_um, spacing_zyx_um, flows_np, out_shape)
    flows = to_device(flows_np, images.device)
    n = images.shape[0]
    if k_ranges is None:
        return torch.stack([
            _affine_flow_warp_core(images[i], flows[i], mats[i], offs[i], strides[i], box_zyx[i],
                                   reference_shape=out_shape, z_chunk=z_chunk)
            for i in range(n)
        ])
    scales = np.stack([np.diag(m) for m in mats]).astype(np.float32)
    group = max(1, int(_FLOW_WARP_BUDGET_BYTES // (_FLOW_WARP_LIVE_PER_ITEM * images[0].numel() * 4)))
    out = torch.empty_like(images)
    for s in range(0, n, group):
        e = min(n, s + group)
        out[s:e] = _flow_warp_separable_core(images[s:e], flows[s:e], scales[s:e], offs[s:e], strides[s:e],
                                             box_zyx[s:e], k_ranges=k_ranges, out_shape=out_shape)
    return out


def warp_affine_plus_flow_batch(
    images: np.ndarray,
    flows_xyz: np.ndarray,
    transforms_zyx_um: np.ndarray,
    spacing_zyx_um,
    map_strides_zyx_px: np.ndarray,
    map_box_starts_xyz_px: np.ndarray,
    *,
    hbm_budget_bytes: int = 12 << 30,
    z_chunk: int = 4,
    device="cuda",
) -> np.ndarray:
    """Host in, host out: sub-batches within ``hbm_budget_bytes`` uploaded
    to ``device`` and warped as :func:`warp_affine_plus_flow_batch_device`
    does, over the whole batch's merged roll ranges, and read back."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    flows_np = np.asarray(flows_xyz, np.float32)
    strides = np.asarray(map_strides_zyx_px, np.float32)
    box_zyx = np.asarray(map_box_starts_xyz_px, np.float32)[:, ::-1].copy()
    out_shape = images.shape[1:]
    mats, offs, k_ranges = _flow_batch_plan(transforms_zyx_um, spacing_zyx_um, flows_np, out_shape)
    scales = np.stack([np.diag(m) for m in mats]).astype(np.float32)
    out = np.empty_like(images)
    live = 6 if k_ranges is not None else 3
    for s, e in _sub_batches(images.shape[0], images[0].nbytes, hbm_budget_bytes, live_per_item=live):
        batch = to_device(images[s:e], device)
        flows = to_device(flows_np[s:e], device)
        if k_ranges is not None:
            res = _flow_warp_separable_core(batch, flows, scales[s:e], offs[s:e], strides[s:e], box_zyx[s:e],
                                            k_ranges=k_ranges, out_shape=out_shape)
        else:
            res = torch.stack([
                _affine_flow_warp_core(batch[j], flows[j], mats[i], offs[i], strides[i], box_zyx[i],
                                       reference_shape=out_shape, z_chunk=z_chunk)
                for j, i in enumerate(range(s, e))
            ])
        out[s:e] = to_host(res)
    return out


def transform_points_to_reference(points_zyx_um: np.ndarray, transform_zyx_um: np.ndarray) -> np.ndarray:
    """Map physical points from moving space back to reference space
    through the inverse affine (float64, returned as float32)."""
    inv = np.linalg.inv(np.asarray(transform_zyx_um, dtype=np.float64))
    pts = np.asarray(points_zyx_um, dtype=np.float64)
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (inv @ homo.T).T[:, :3].astype(np.float32)
