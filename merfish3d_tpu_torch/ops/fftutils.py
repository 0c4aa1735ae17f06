"""FFT sizing, linear-convolution padding and spectral transforms on
(real, imag) float32 pairs (counterpart of ``merfish3d_tpu/ops/fftutils.py``
and of the 3D dispatch of ``merfish3d_tpu/ops/mmfft.py``).

**Sizing.** :func:`next_smooth_fft_size` takes the smallest n1·128 length
that :func:`.pfft.supported_ct_axis` admits when it is at most
max(2,3-smooth cover, ⌊1.15·x⌋) — the reference's TPU branch — and the
2,3-smooth cover with at most 3³ in it otherwise — the reference's
non-TPU branch. (The reference's TPU branch for the other lengths picks
the cheapest composite for its einsum FFT; the port runs those axes with
``torch.fft``, which wants a smooth length.) So a length that takes no
lane pads as in the reference's CPU tests (110 → 128: the hermetic decon
cases pad to (27, 128, 128)), and one that takes a lane pads as on the
TPU (1038 → 1152, 2062 → 2176: the production tile pads to
(32, 1152, 1152)).

**Padding.** Symmetric padding is numpy's ``"symmetric"`` (the edge
sample repeats, for pads of any width), built from index maps:
``torch.nn.functional.pad(mode="reflect")`` is numpy's ``"reflect"``.

**Transforms.** :func:`fftn_spec` / :func:`ifftn_spec` keep the per-axis
spectrum order of :mod:`.pfft` (scrambled for Cooley-Tukey lengths,
natural otherwise), the order the reference's TPU dispatch produces;
:func:`spectrum_freqs` names the frequency at each position. 3D volumes
go through the DFT kernels where the reference's predicates take them —
K10 (z and x in one pass) then K7 (y) where :func:`.pfft.zx_supported`,
else K6 (x), K7 (y) and K8 (z) axis by axis in the reference's order. An
axis no kernel takes goes to ``torch.fft``, the counterpart of the
reference's einsum FFT, which runs outside Pallas; so do 2D and other
ranks. A 3D convolution (:func:`fft_conv_spec`) is K10 forward → K9 → K10
inverse where both fused passes take the shape, and the composed
transforms elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import to_device
from . import pfft
from .filters import symmetric_pad_index

PadWidth = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]


# ---------------------------------------------------------------- sizing
def _next_23_smooth(x: int) -> int:
    """Smallest 2,3-smooth integer >= x with at most 3^3 in the factor 3."""
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
    """FFT-padded axis length >= x: the smallest n1·128 length the
    Cooley-Tukey kernels take when it is at most max(cover, ⌊1.15·x⌋),
    else the 2,3-smooth cover (module docstring)."""
    if x <= 1:
        return 1
    cover = _next_23_smooth(x)
    lane = ((int(x) + 127) // 128) * 128
    if pfft.supported_ct_axis(lane) and lane <= max(cover, int(x * 1.15)):
        return lane
    return cover


def axis_linear_fft_padding(length: int, psf_support: int, halo_multiplier: int = 1) -> tuple[int, int]:
    """Per-axis (before, after) padding: PSF halo + growth to a smooth FFT
    size."""
    halo = max((int(psf_support) // 2) * int(halo_multiplier), 0)
    length_with_halo = length + 2 * halo
    fft_extra = next_smooth_fft_size(length_with_halo) - length_with_halo
    return halo + fft_extra // 2, halo + fft_extra - fft_extra // 2


def linear_fft_pad_width(image_shape, psf_shape, pad_yx: bool = True) -> PadWidth:
    """Static pad widths for a linear FFT convolution of a 3D image."""
    pad_z = axis_linear_fft_padding(image_shape[0], psf_shape[0])
    if not pad_yx:
        return (pad_z, (0, 0), (0, 0))
    return (
        pad_z,
        axis_linear_fft_padding(image_shape[1], psf_shape[1]),
        axis_linear_fft_padding(image_shape[2], psf_shape[2]),
    )


# --------------------------------------------------------------- padding
def _gather(arr: torch.Tensor, maps) -> torch.Tensor:
    """arr[maps[0][:, None, None], maps[1][None, :, None], maps[2][None, None, :]]:
    one gather over the trailing three axes."""
    iz, iy, ix = (to_device(m, arr.device) for m in maps)
    return arr[..., iz[:, None, None], iy[None, :, None], ix[None, None, :]]


def pad_symmetric(image: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    """numpy's ``"symmetric"`` padding of the trailing three axes."""
    shape = image.shape[-3:]
    return _gather(image, [symmetric_pad_index(n, b, a) for n, (b, a) in zip(shape, pad_width)])


def remove_padding_zyx(arr: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    n = arr.shape[-3:]
    return arr[..., pad_width[0][0]:n[0] - pad_width[0][1], pad_width[1][0]:n[1] - pad_width[1][1],
               pad_width[2][0]:n[2] - pad_width[2][1]]


def enforce_symmetric_boundary(arr: torch.Tensor, pad_width: PadWidth) -> torch.Tensor:
    """Rebuild the padding region as the symmetric reflection of the
    interior (crop then re-pad, as one gather)."""
    maps = [symmetric_pad_index(n - b - a, b, a) + b for n, (b, a) in zip(arr.shape[-3:], pad_width)]
    return _gather(arr, maps)


def observed_region_mask(shape, pad_width: PadWidth, device="cpu") -> torch.Tensor:
    """float32 mask of the original (unpadded) region of a padded shape."""
    mask = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    mask[tuple(slice(b, n - a) for n, (b, a) in zip(shape, pad_width))] = 1.0
    return mask


def pad_psf(psf, image_shape, normalize: bool = True) -> np.ndarray:
    """Embed and center a PSF in the padded image shape and ifftshift it,
    so that a full-spectrum product with its transform is a centered
    convolution. Host numpy in, float32 numpy out."""
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
    if normalize:
        s = embedded.sum(dtype=np.float32)
        embedded = embedded / (s if s != 0 else np.float32(1.0))
    return embedded.astype(np.float32)


def c_mul(a, b):
    """(ar, ai) * (br, bi) elementwise complex product on pairs."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def c_conj(a):
    ar, ai = a
    return ar, -ai


def fftn_pair(xr: torch.Tensor, xi=None):
    """Full-spectrum N-D DFT in natural order → (real, imag)."""
    z = torch.complex(xr.float(), xi.float()) if xi is not None else xr.to(torch.complex64)
    f = torch.fft.fftn(z)
    return f.real.contiguous(), f.imag.contiguous()


def ifftn_pair(xr: torch.Tensor, xi: torch.Tensor):
    z = torch.complex(xr.float(), xi.float())
    f = torch.fft.ifftn(z)
    return f.real.contiguous(), f.imag.contiguous()


def _axis(xr, xi, ax: int, *, inverse: bool, real_output: bool = False):
    """One axis through its kernel where the reference's predicate takes
    it, else through ``torch.fft`` in the same spectrum order."""
    if pfft.axis_supported(xr.shape, ax):
        return pfft.dft_axis_3d(xr, xi, ax, inverse=inverse, real_output=real_output)
    return pfft.axis_plain(xr, xi, ax, inverse, real_output)


def fftn_spec(xr: torch.Tensor, xi=None):
    """Forward N-D DFT pair in the spectrum order of :mod:`.pfft` (the
    reference's dispatch on the TPU, ``mmfft.fftn_pair_s``)."""
    xr = xr.to(torch.float32).contiguous()
    xi = None if xi is None else xi.to(torch.float32).contiguous()
    if xr.ndim == 3:
        if pfft.zx_supported(xr.shape):
            # z and x in one pass, while the input may still be real
            xr, xi = pfft.dft_zx(xr, xi)
            return _axis(xr, xi, 1, inverse=False)
        # trailing (largest) axis first, while the input may still be real
        for ax in (2, 1, 0):
            xr, xi = _axis(xr, xi, ax, inverse=False)
        return xr, xi
    for ax in range(xr.ndim):
        xr, xi = pfft.axis_plain(xr, xi, ax, False, False)
    return xr, xi


def ifftn_spec(xr: torch.Tensor, xi, real_output: bool = False):
    """Inverse of :func:`fftn_spec` (natural-order spatial output; the
    reference's ``mmfft.ifftn_pair_s``); ``real_output`` skips the
    imaginary channel of the last axis and returns ``(real, None)``."""
    xr = xr.to(torch.float32).contiguous()
    xi = None if xi is None else xi.to(torch.float32).contiguous()
    if xr.ndim == 3:
        if pfft.zx_supported(xr.shape):
            xr, xi = _axis(xr, xi, 1, inverse=True)
            return pfft.dft_zx(xr, xi, inverse=True, real_output=real_output)
        # trailing axis last, so real_output halves its work
        for ax in (1, 0, 2):
            xr, xi = _axis(xr, xi, ax, inverse=True, real_output=real_output and ax == 2)
        return xr, xi
    for ax in range(xr.ndim):
        last = ax == xr.ndim - 1
        xr, xi = pfft.axis_plain(xr, xi, ax, True, real_output and last)
    return xr, xi


def spectrum_freqs(n: int) -> np.ndarray:
    """1-D frequency values (cycles/sample) in :func:`fftn_spec`'s
    spectrum order for an axis of length n."""
    return np.fft.fftfreq(n).astype(np.float32)[pfft.scramble_perm(n)]


# ---------------------------------------------------------- convolution
def fft_conv_spec(xr: torch.Tensor, xi, H_pair, real_output: bool = False):
    """Spectrum-domain convolution of a (real, imag) pair with an OTF pair
    in :func:`fftn_spec` order (``mmfft.conv_pair_s``): K10 forward, K9,
    K10 inverse where :func:`.pfft.zx_supported` and
    :func:`.pfft.mid_conv_supported` both take the shape — three passes
    over the volume, the y spectrum never stored — else the composed
    transforms."""
    xr = xr.to(torch.float32).contiguous()
    xi = None if xi is None else xi.to(torch.float32).contiguous()
    hr, hi = H_pair
    if xr.ndim == 3 and pfft.zx_supported(xr.shape) and pfft.mid_conv_supported(xr.shape):
        fr, fi = pfft.dft_zx(xr, xi)
        gr, gi = pfft.dft_mid_conv(fr, fi, hr, hi)
        return pfft.dft_zx(gr, gi, inverse=True, real_output=real_output)
    return ifftn_spec(*c_mul(fftn_spec(xr, xi), H_pair), real_output=real_output)


def fft_conv_full(image: torch.Tensor, H_pair) -> torch.Tensor:
    """Linear convolution of a real volume through the full spectrum in
    :func:`fftn_spec` order."""
    return fft_conv_spec(image, None, H_pair, real_output=True)[0]
