"""Fused Gaussian lowpass + nearest-codeword decode (counterpart of
``merfish3d_tpu/ops/fused_decode.py``).

:func:`fused_lowpass_decode` dispatches on the device of its input:

- CUDA: kernel K1 (``zy_lowpass_f32``: y and z passes into an f32
  intermediate) then kernel K2 (``x_lowpass_decode_f32``: x pass fused
  with scale → clip → unit trace → codebook projection → argmax →
  thresholds), both in ``csrc/fused_decode.cu``.
- CPU: the plain version, :func:`gaussian_lowpass` + the plain decode —
  what the reference computes on CPU.

Outputs: decoded int16 (Z, Y, X), magnitude and distance float16
(Z, Y, X), scaled float16 (bits, Z, Y, X).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count, to_device
from .device import as_device_tensor
from .decode import (
    assign_pixels,
    check_decode_inputs,
    decode_chunk_plain,
    normalize_codebook,
    output_sink,
    pack_codebook,
)
from .filters import _gaussian_kernel1d, gaussian_lowpass, symmetric_pad_index

def _kernel_or_identity(sigma: float) -> np.ndarray:
    if sigma and sigma > 0:
        return _gaussian_kernel1d(float(sigma))
    return np.ones(1, np.float32)


def z_fold_matrix(kernel: np.ndarray, nz: int) -> np.ndarray:
    """(nz, nz) matrix W with ``W @ v`` = the symmetric-padded z conv of a
    length-nz column: the np.pad index map folded into the banded conv
    (exact for any pad width, including pads longer than the column)."""
    r = (len(kernel) - 1) // 2
    pad_idx = symmetric_pad_index(nz, r, r)
    w = np.zeros((nz, nz), np.float32)
    for o in range(nz):
        for k in range(len(kernel)):
            w[o, pad_idx[o + k]] += kernel[k]
    return w


def zy_lowpass_plain(volume: torch.Tensor, sigma) -> torch.Tensor:
    """What K1 computes: the z and y passes of the lowpass."""
    return gaussian_lowpass(volume, sigma=(sigma[0], sigma[1], 0.0))


def _check_volume(volume: torch.Tensor, *, kernel: bool) -> None:
    """Refuse what the path cannot take: any path needs a contiguous
    float32 (bits, Z, Y, X) tensor; the kernels also need bits <= 32 (K2
    holds a trace in registers) and Z, Y <= 65535 (grid dimensions)."""
    if volume.dtype != torch.float32 or volume.ndim != 4 or not volume.is_contiguous():
        raise ValueError(
            f"volume must be a contiguous float32 (bits, Z, Y, X) tensor, got "
            f"{volume.dtype} {tuple(volume.shape)}"
        )
    bits, nz, ny, nx = volume.shape
    if kernel and not (1 <= bits <= 32 and 1 <= nz <= 65535 and 1 <= ny <= 65535 and nx >= 1):
        raise ValueError(
            f"kernels take bits<=32, Z<=65535, Y<=65535; got {tuple(volume.shape)}"
        )


def _index_map(n: int, kernel: np.ndarray, device) -> torch.Tensor:
    r = (len(kernel) - 1) // 2
    return to_device(symmetric_pad_index(n, r, r).astype(np.int32), device)


@functools.lru_cache(maxsize=64)
def _x_taps(nx: int, sigma_x: float, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's x taps and symmetric pad index map on ``device``, uploaded once
    a row length and sigma (each upload from host memory costs a copy)."""
    kx = _kernel_or_identity(sigma_x)
    return to_device(kx, device), _index_map(nx, kx, device)


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {t.device}")


class ZyTables(NamedTuple):
    """K1's tables on one device. Up to 64 planes the kernel folds z through
    ``wz`` and takes neither ``kz`` nor ``zmap``; deeper, its direct path
    takes those and not ``wz``."""

    wz: Optional[torch.Tensor]  # (nz, nz) z fold
    kz: Optional[torch.Tensor]  # (taps_z,) z taps
    zmap: Optional[torch.Tensor]  # (nz + taps_z - 1,) z pad's source plane
    ky: torch.Tensor  # (taps_y,) y taps
    ymap: torch.Tensor  # (ny + taps_y - 1,) y pad's source row
    taps_z: int


@functools.lru_cache(maxsize=64)
def _zy_tables(nz: int, ny: int, sigma_z: float, sigma_y: float, device: torch.device) -> ZyTables:
    """K1's tables on ``device``, built and uploaded once a depth, row count
    and sigma pair (each upload from host memory costs a copy)."""
    kz, ky = _kernel_or_identity(sigma_z), _kernel_or_identity(sigma_y)
    fold = nz <= 64
    return ZyTables(
        wz=to_device(z_fold_matrix(kz, nz), device) if fold else None,
        kz=None if fold else to_device(kz, device),
        zmap=None if fold else _index_map(nz, kz, device),
        ky=to_device(ky, device),
        ymap=_index_map(ny, ky, device),
        taps_z=len(kz),
    )


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def zy_route(shape, sigma) -> dict:
    """K1's launch shape for a (bits, Z, Y, X) volume and sigma, as the kernel
    library reports it: the kernel (``staged`` up to 64 planes, else
    ``direct``), output rows a segment, columns a tile, shared bytes a block,
    resident blocks an SM, threads a block and blocks in the grid. Needs the
    card."""
    bits, nz, ny, nx = shape
    info = (ctypes.c_int * 7)()
    taps_y = len(_kernel_or_identity(sigma[1]))
    _build.check(_build.kernels().zy_lowpass_route(bits, nz, ny, nx, taps_y, info),
                 "zy_lowpass_route")
    keys = ("seg_rows", "tile_x", "smem_bytes", "blocks_per_sm", "threads", "grid")
    return {"kernel": "staged" if info[0] else "direct", **dict(zip(keys, info[1:]))}


def zy_lowpass_cuda(volume: torch.Tensor, sigma) -> torch.Tensor:
    """Kernel K1 on a CUDA tensor; same result as :func:`zy_lowpass_plain`.
    Up to 64 planes the z pass is the folded (Z, Z) matrix; deeper volumes
    take the kernel's direct z-tap path. The tables come from
    :func:`_zy_tables`, so a repeated shape uploads nothing."""
    _require_cuda(volume, "zy_lowpass_cuda")
    _check_volume(volume, kernel=True)
    bits, nz, ny, nx = volume.shape
    tab = _zy_tables(nz, ny, float(sigma[0]), float(sigma[1]), volume.device)
    out = torch.empty_like(volume)
    status = _build.kernels().zy_lowpass_f32(
        volume.data_ptr(), _ptr(tab.wz), _ptr(tab.kz), _ptr(tab.zmap), tab.taps_z,
        tab.ky.data_ptr(), tab.ymap.data_ptr(), bits, nz, ny, nx, tab.ky.numel(),
        out.data_ptr(), _build.stream_handle(volume.device),
    )
    _build.check(status, "zy_lowpass_f32")
    count("launch.zy_lowpass_f32")
    return out


def x_lowpass_decode_cuda(
    inter, codebook_t, background, normalization, *, sigma_x,
    magnitude_threshold, distance_threshold,
):
    """Kernel K2 on the output of K1 (the codebook uploaded as
    :func:`~.decode.pack_codebook` lays it out)."""
    _require_cuda(inter, "x_lowpass_decode_cuda")
    _check_volume(inter, kernel=True)
    bits, nz, ny, nx = inter.shape
    check_decode_inputs(inter.reshape(bits, -1), codebook_t, background, normalization)
    dev = inter.device
    kx_t, xmap = _x_taps(nx, float(sigma_x), dev)
    cb = pack_codebook(codebook_t)
    decoded = torch.empty((nz, ny, nx), dtype=torch.int16, device=dev)
    mag = torch.empty((nz, ny, nx), dtype=torch.float16, device=dev)
    dist = torch.empty((nz, ny, nx), dtype=torch.float16, device=dev)
    scaled = torch.empty((bits, nz, ny, nx), dtype=torch.float16, device=dev)
    lo, hi = magnitude_threshold
    status = _build.kernels().x_lowpass_decode_f32(
        inter.data_ptr(), kx_t.data_ptr(), xmap.data_ptr(), kx_t.numel(),
        cb.data_ptr(), background.data_ptr(), normalization.data_ptr(),
        bits, cb.shape[0], nz, ny, nx, float(lo), float(hi),
        float(distance_threshold), decoded.data_ptr(), mag.data_ptr(),
        dist.data_ptr(), scaled.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(status, "x_lowpass_decode_f32")
    count("launch.x_lowpass_decode_f32")
    return decoded, mag, dist, scaled


def x_lowpass_decode_plain(
    inter, codebook_t, background, normalization, *, sigma_x,
    magnitude_threshold, distance_threshold,
):
    """What K2 computes, in plain torch: the x pass, then the decode."""
    lp = gaussian_lowpass(inter, sigma=(0.0, 0.0, sigma_x))
    bits = lp.shape[0]
    chunk = decode_chunk_plain(lp.reshape(bits, -1), codebook_t, background, normalization)
    return assign_pixels(
        *chunk, lp.shape,
        magnitude_threshold=magnitude_threshold,
        distance_threshold=distance_threshold,
    )


def fused_lowpass_decode_plain(
    volume, codebook_t, background, normalization, *, sigma,
    magnitude_threshold, distance_threshold,
):
    """Plain torch version of K1+K2: ``gaussian_lowpass`` (z, y, then x)
    followed by the plain decode."""
    return x_lowpass_decode_plain(
        zy_lowpass_plain(volume, sigma), codebook_t, background, normalization,
        sigma_x=sigma[2], magnitude_threshold=magnitude_threshold,
        distance_threshold=distance_threshold,
    )


def fused_lowpass_decode(
    volume: torch.Tensor,  # (bits, Z, Y, X) float32
    codebook_t: torch.Tensor,  # (bits, words) L2-normalized
    background: torch.Tensor,
    normalization: torch.Tensor,
    *,
    sigma=(3.0, 1.0, 1.0),
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float = 0.5172,
):
    """Returns (decoded int16, magnitude f16, distance f16, scaled f16)
    tensors on the input's device: K1+K2 on CUDA, the plain version on CPU."""
    kw = dict(
        magnitude_threshold=tuple(magnitude_threshold),
        distance_threshold=float(distance_threshold),
    )
    if volume.device.type == "cuda":
        inter = zy_lowpass_cuda(volume, sigma)
        return x_lowpass_decode_cuda(
            inter, codebook_t, background, normalization, sigma_x=sigma[2], **kw
        )
    if volume.device.type != "cpu":
        raise ValueError(f"unsupported device {volume.device}")
    _check_volume(volume, kernel=False)
    check_decode_inputs(
        volume.reshape(volume.shape[0], -1), codebook_t, background, normalization
    )
    return fused_lowpass_decode_plain(
        volume, codebook_t, background, normalization, sigma=tuple(sigma), **kw
    )


def fused_decode_volume(
    bit_volume,  # (bits, Z, Y, X) tensor or array
    codebook_matrix: np.ndarray,  # (words, bits) raw 0/1
    background,
    normalization,
    *,
    sigma=(3.0, 1.0, 1.0),
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float,
    y_slab: int = 512,
    memory_budget_bytes: int = 12 << 30,
    device=None,
    on_device: bool = False,
):
    """Run the fused pipeline on the whole volume when its working set
    (input + f32 intermediate + f16 outputs ≈ 3× the f32 input) fits
    ``memory_budget_bytes``, else stream y-slabs with ``ry`` halo rows
    on each side (each slab's true edges reflect in the kernel, so the
    result equals the whole-volume one).

    Returns host numpy arrays (decoded int16, magnitude f16, distance
    f16, scaled f16 (bits, Z, Y, X)); with ``on_device`` the same four as
    tensors on the decode's device, and nothing is downloaded. ``device``
    defaults to the input tensor's, and to ``cuda`` for a host array."""
    vol = as_device_tensor(bit_volume, device).to(torch.float32).contiguous()
    dev = vol.device
    bits, nz, ny, nx = vol.shape
    cb_t = to_device(normalize_codebook(codebook_matrix).T.copy(), dev)
    bg = to_device(np.asarray(background, np.float32), dev)
    norm = to_device(np.asarray(normalization, np.float32), dev)
    kw = dict(
        sigma=tuple(float(s) for s in sigma),
        magnitude_threshold=tuple(magnitude_threshold),
        distance_threshold=float(distance_threshold),
    )
    empty, put = output_sink(dev, on_device)
    if 3 * vol.numel() * 4 <= memory_budget_bytes:
        return tuple(put(t) for t in fused_lowpass_decode(vol, cb_t, bg, norm, **kw))

    ry = int(4.0 * sigma[1] + 0.5) if sigma[1] > 0 else 0
    decoded = empty((nz, ny, nx), "int16")
    mag = empty((nz, ny, nx), "float16")
    dist = empty((nz, ny, nx), "float16")
    scaled = empty((bits, nz, ny, nx), "float16")
    for y0 in range(0, ny, y_slab):
        y1 = min(y0 + y_slab, ny)
        ys, ye = max(0, y0 - ry), min(ny, y1 + ry)
        d, m, di, s = fused_lowpass_decode(
            vol[:, :, ys:ye].contiguous(), cb_t, bg, norm, **kw
        )
        lo, hi = y0 - ys, y1 - ys
        decoded[:, y0:y1] = put(d[:, lo:hi])
        mag[:, y0:y1] = put(m[:, lo:hi])
        dist[:, y0:y1] = put(di[:, lo:hi])
        scaled[:, :, y0:y1] = put(s[:, :, lo:hi])
    return decoded, mag, dist, scaled
