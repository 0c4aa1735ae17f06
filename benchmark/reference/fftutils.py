"""FFT sizing, linear-convolution padding and transforms on (real, imag)
float32 pairs, with ``torch.fft`` in natural spectrum order.

The sizing rule is the program's at the time the benchmark was defined
(an n1·128 length, 2 <= n1 <= 24, where it is at most
max(2,3-smooth cover, ⌊1.15·x⌋), else the 2,3-smooth cover with at most
3³), so both sides solve on the same padded grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import symmetric_pad_index
from .precision import q

PadWidth = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]
_LANE = 128
_MAX_N1 = 24


def _next_23_smooth(x: int) -> int:
    if x <= 1:
        return 1
    n = int(x)
    while True:
        m = n
        while m % 2 == 0:
            m //= 2
        threes = 0
        while m % 3 == 0:
            m //= 3
            threes += 1
        if m == 1 and threes <= 3:
            return n
        n += 1


def next_smooth_fft_size(x: int) -> int:
    if x <= 1:
        return 1
    cover = _next_23_smooth(x)
    lane = ((int(x) + _LANE - 1) // _LANE) * _LANE
    if 2 <= lane // _LANE <= _MAX_N1 and lane <= max(cover, int(x * 1.15)):
        return lane
    return cover


def axis_linear_fft_padding(length: int, psf_support: int) -> tuple[int, int]:
    halo = max(int(psf_support) // 2, 0)
    length_with_halo = length + 2 * halo
    fft_extra = next_smooth_fft_size(length_with_halo) - length_with_halo
    return halo + fft_extra // 2, halo + fft_extra - fft_extra // 2


def linear_fft_pad_width(image_shape, psf_shape) -> PadWidth:
    return tuple(axis_linear_fft_padding(n, p) for n, p in zip(image_shape, psf_shape))


def padded_shape(image_shape, psf_shape) -> tuple[int, int, int]:
    return tuple(n + b + a for n, (b, a) in zip(image_shape, linear_fft_pad_width(image_shape, psf_shape)))


def _gather(arr: torch.Tensor, maps) -> torch.Tensor:
    iz, iy, ix = (torch.as_tensor(m, device=arr.device) for m in maps)
    return arr[..., iz[:, None, None], iy[None, :, None], ix[None, None, :]]


def pad_symmetric(image: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    shape = image.shape[-3:]
    return _gather(image, [symmetric_pad_index(n, b, a) for n, (b, a) in zip(shape, pad_width)])


def remove_padding_zyx(arr: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    n = arr.shape[-3:]
    return arr[..., pad_width[0][0]:n[0] - pad_width[0][1], pad_width[1][0]:n[1] - pad_width[1][1],
               pad_width[2][0]:n[2] - pad_width[2][1]]


def enforce_symmetric_boundary(arr: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    maps = [symmetric_pad_index(n - b - a, b, a) + b for n, (b, a) in zip(arr.shape[-3:], pad_width)]
    return _gather(arr, maps)


def observed_region_mask(shape, pad_width: PadWidth, device="cpu") -> torch.Tensor:
    mask = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    mask[tuple(slice(b, n - a) for n, (b, a) in zip(shape, pad_width))] = 1.0
    return mask


def pad_psf(psf, image_shape) -> np.ndarray:
    """The PSF embedded, centred and ifftshifted in the padded shape,
    normalized to unit sum."""
    psf = np.asarray(psf, np.float32)
    if psf.ndim == 2:
        psf = psf[None]
    embedded = np.zeros(tuple(image_shape), np.float32)
    embedded[: psf.shape[0], : psf.shape[1], : psf.shape[2]] = psf
    for axis, axis_size in enumerate(image_shape):
        embedded = np.roll(embedded, int(axis_size / 2), axis=axis)
    for axis, axis_size in enumerate(psf.shape):
        embedded = np.roll(embedded, -int(axis_size / 2), axis=axis)
    embedded = np.fft.ifftshift(embedded)
    s = embedded.sum(dtype=np.float32)
    return (embedded / (s if s != 0 else np.float32(1.0))).astype(np.float32)


def c_mul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def c_conj(a):
    ar, ai = a
    return ar, -ai


def fftn_spec(xr: torch.Tensor, xi=None):
    """Forward N-D DFT pair, natural order."""
    z = torch.complex(xr.float(), xi.float()) if xi is not None else xr.float().to(torch.complex64)
    f = torch.fft.fftn(z)
    return q(f.real.contiguous()), q(f.imag.contiguous())


def ifftn_spec(xr: torch.Tensor, xi, real_output: bool = False):
    """Inverse of :func:`fftn_spec`; ``real_output`` returns ``(real, None)``."""
    f = torch.fft.ifftn(torch.complex(xr.float(), xi.float()))
    if real_output:
        return q(f.real.contiguous()), None
    return q(f.real.contiguous()), q(f.imag.contiguous())


def spectrum_freqs(n: int) -> np.ndarray:
    return np.fft.fftfreq(n).astype(np.float32)


def fft_conv_spec(xr: torch.Tensor, xi, H_pair, real_output: bool = False):
    return ifftn_spec(*c_mul(fftn_spec(xr, xi), H_pair), real_output=real_output)


def fft_conv_full(image: torch.Tensor, H_pair) -> torch.Tensor:
    return fft_conv_spec(image, None, H_pair, real_output=True)[0]
