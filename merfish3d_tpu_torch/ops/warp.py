"""Affine volume warps (counterpart of the affine half of
``merfish3d_tpu/ops/warp.py``): ``transform_to_pixel``, the three warp
classes (``translate_volume``, ``separable_diagonal_resample`` and the
trilinear ``_affine_warp_core``), ``warp_affine``, the batched forms and
``transform_points_to_reference``.

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
coordinates round positions differently. The warps take and return
tensors on the input's device. The flow warps are not ported.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

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
    shift = torch.as_tensor(shift_pull_px, dtype=torch.float32, device=vol.device)
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


def _interp_nodes(coord: torch.Tensor, size: int, order: int):
    """JAX's per-axis (index, valid, weight) nodes of order 0 or 1; weight
    None is the unit weight of order 0."""
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
    return [(i.clamp(0, size - 1), (i >= 0) & (i < size), w) for i, w in nodes]


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
    flat = img.reshape(-1)
    sz, sy, sx = img.shape
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
        nodes = [_interp_nodes(c, size, order) for c, size in zip(src, (sz, sy, sx))]
        acc = None
        for (iz, vz, wz), (iy, vy, wy), (ix, vx, wx) in itertools.product(*nodes):
            corner = torch.where(vz & vy & vx, flat[(iz * sy + iy) * sx + ix], cval)
            if wz is not None:
                corner = wz * wy * wx * corner
            acc = corner if acc is None else acc + corner
        out[z0: z0 + zc.shape[0]] = acc
    return out


def _warp_class(matrix_px: np.ndarray) -> str:
    """The reference's split: diagonal within 1e-8, and then a unit
    diagonal within 1e-6 is a translation."""
    if not np.allclose(matrix_px, np.diag(np.diag(matrix_px)), atol=1e-8):
        return "general"
    return "translate" if np.allclose(np.diag(matrix_px), 1.0, atol=1e-6) else "diagonal"


def _warp_one(image, kind, matrix_px, offset_px, reference_shape, *, order=1, z_chunk=8, cval=0.0):
    if kind == "translate":
        return translate_volume(image, torch.as_tensor(offset_px, device=image.device), cval=cval)
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
            batch = torch.as_tensor(images[sel], device=device)
            for j, i in enumerate(sel):
                out[i] = _warp_one(batch[j], kind, mats[i], offs[i], images.shape[1:]).cpu().numpy()
    return out


def transform_points_to_reference(points_zyx_um: np.ndarray, transform_zyx_um: np.ndarray) -> np.ndarray:
    """Map physical points from moving space back to reference space
    through the inverse affine (float64, returned as float32)."""
    inv = np.linalg.inv(np.asarray(transform_zyx_um, dtype=np.float64))
    pts = np.asarray(points_zyx_um, dtype=np.float64)
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (inv @ homo.T).T[:, :3].astype(np.float32)
