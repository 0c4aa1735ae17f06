"""Per-axis DFT kernels on (real, imag) float32 pairs (counterpart of
``merfish3d_tpu/ops/pfft.py`` and of the spectrum-layout policy of
``merfish3d_tpu/ops/mmfft.py``).

Five kernels, hand-written CUDA in ``csrc/pfft.cu``; every 128-point
stage is the radix FFT of ``csrc/fft128.cuh``:

- K6 :func:`dft_trailing` — DFT along the last axis of a (rows, n) pair
  (one launch of K10's x pass, a line a block),
- K7 :func:`dft_middle` — DFT along axis 1 of a (z, n, x) pair (two
  launches: the n1-point stage along y with lanes along x, and the
  128-point FFTs of 32-column tiles staged transposed),
- K8 :func:`dft_leading` — DFT along axis 0 of a (n, y, x) pair, natural
  order (one launch, by the length alone, :func:`leading_route`: a column
  a thread in registers for n = R·M ≤ 64, M ∈ {8, 16}, else K10's dense
  z pass),
- K10 :func:`dft_zx` — DFT along axes 0 and 2 of a (z, y, x) pair in one
  call (an x pass whose 128-point stage is a radix FFT, then a dense z
  pass),
- K9 :func:`dft_mid_conv` — forward y DFT, product with an OTF pair in
  the same scrambled order, inverse y DFT (the middle pass of an RLGC
  convolution; three launches: K7's n1-point pass forward, K7's staged
  128-point FFTs with the OTF product between forward and inverse, K7's
  n1-point pass inverse).

Spectrum order is a function of the axis length alone, as on the TPU: a
Cooley-Tukey length n = n1·128 (2 <= n1 <= 24, :func:`supported_ct_axis`)
keeps the scrambled (n1, 128) layout — position s holds natural frequency
n1·(s % 128) + s // 128 (:func:`scramble_perm`) — and every other length
is in natural order. Inverses consume that layout and write natural
order, with the 1/n scale folded into their constants.

Each entry point launches its kernel on a CUDA tensor (or raises) and
runs its plain version on a CPU tensor: ``torch.fft`` along the axis,
then ``index_select`` by :func:`scramble_perm` (inverse: the inverse
permutation, then ``torch.fft.ifft``, which carries the 1/n scale). The
shape predicates are the reference's, so every shape takes the kernel
it takes on the TPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count, to_device

_LANE = 128
_MAX_N1 = 24
_ZX_TY = 8

# ------------------------------------------------------------ predicates
def supported_ct_axis(n: int) -> bool:
    """Trailing/middle axis lengths the Cooley-Tukey kernels accept."""
    return n % _LANE == 0 and 2 <= n // _LANE <= _MAX_N1


def supported_dense_axis(n: int) -> bool:
    """Leading (z) lengths of the dense kernels."""
    return 2 <= n <= 96


def zx_supported(shape) -> bool:
    """Does the fused z+x kernel take axes (0, 2) of this 3D shape? The
    reference's gate, byte budget included, so the same shapes take it."""
    if len(shape) != 3:
        return False
    nz, ny, nx = (int(v) for v in shape)
    if not (supported_dense_axis(nz) and supported_ct_axis(nx)):
        return False
    if ny % _ZX_TY != 0:
        return False
    n1 = nx // _LANE
    io_bytes = 5 * nz * _ZX_TY * nx * 4
    live_bytes = 2 * n1 * nz * _ZX_TY * _LANE * 4
    return io_bytes + live_bytes <= 12 * 1024 * 1024


def mid_conv_supported(shape) -> bool:
    """Does K9 take the y axis of this 3D shape? The reference's gate,
    byte budget included, so the same shapes take it."""
    if len(shape) != 3:
        return False
    nz, ny, nx = (int(v) for v in shape)
    if not (supported_ct_axis(ny) and nx % _LANE == 0):
        return False
    return ny * _LANE * 4 * 12 <= 14 * 1024 * 1024


def axis_supported(shape, axis: int) -> bool:
    """Does a per-axis kernel take this axis of a 3D shape?"""
    if len(shape) != 3:
        return False
    n = shape[axis]
    axis = axis % 3
    if axis == 0:
        return supported_dense_axis(n) and shape[2] % _LANE == 0 and shape[1] % 8 == 0
    if axis == 1:
        return supported_ct_axis(n) and shape[2] % _LANE == 0
    return supported_ct_axis(n) and (shape[0] * shape[1]) % 8 == 0


# ---------------------------------------------------------------- layout
def fft_axis_split(n: int) -> tuple[int, int]:
    """(n1, 128) for a Cooley-Tukey length, else (1, n): no split, natural
    order. (The reference splits other lengths above 96 in balance for
    its einsum FFT; the port transforms them with ``torch.fft`` and keeps
    natural order there.)"""
    if supported_ct_axis(n):
        return n // _LANE, _LANE
    return 1, n


@lru_cache(maxsize=None)
def scramble_perm(n: int) -> np.ndarray:
    """perm[s] = natural frequency index stored at position s of a
    spectrum axis of length n (identity where there is no split)."""
    n1, n2 = fft_axis_split(n)
    s = np.arange(n)
    if n1 == 1:
        return s
    return n1 * (s % n2) + s // n2


@lru_cache(maxsize=None)
def _consts_ct(n: int, inverse: bool):
    """(w1 (n1, n1), twiddle (n1, 128)) complex64 for the Cooley-Tukey
    kernels; inverse constants are conjugated, with the 1/n scale folded
    into the twiddle."""
    n1 = n // _LANE
    sign = +1.0 if inverse else -1.0
    k = np.arange(n1)
    w1 = np.exp(sign * 2j * np.pi * np.outer(k, k) / n1)
    q = np.arange(_LANE)
    tw = np.exp(sign * 2j * np.pi * np.outer(k, q) / n)
    if inverse:
        tw = tw / n
    return w1.astype(np.complex64), tw.astype(np.complex64)


@lru_cache(maxsize=None)
def _consts_fft128(inverse: bool) -> np.ndarray:
    """W128^j = exp(-+2πij/128), j < 128, complex64: the twiddles between
    the 16- and 8-point factors of the 128-point FFT (``fft128.cuh``);
    no scale (the inverse's 1/n is in the Cooley-Tukey twiddle)."""
    sign = +1.0 if inverse else -1.0
    return np.exp(sign * 2j * np.pi * np.arange(_LANE) / _LANE).astype(np.complex64)


def ct_tables(n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """The host tables of the radix kernels (K6, K7, K9, K10's x pass) for
    a Cooley-Tukey length n: w1 (n1, n1) and the twiddle (n1, 128) of
    :func:`_consts_ct`, and the 128-point FFT's twiddles (128,)."""
    return (*_consts_ct(n, inverse), _consts_fft128(inverse))


def dense_z_table(nz: int, inverse: bool) -> np.ndarray:
    """The z pass's table (K10, K8's dense route): the dense nz-point DFT,
    symmetric, stored as (nz, nzp) with nzp = nz rounded up to a multiple
    of 8 and zeros past nz (the pass reads 8 outputs' entries as aligned
    pairs)."""
    wz = np.zeros((nz, -(-nz // 8) * 8), np.complex64)
    wz[:, :nz] = _consts_dense(nz, inverse)
    return wz


def zx_tables(nz: int, nx: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """The host tables K10 uploads for a (nz, ·, nx) volume: those of
    :func:`ct_tables` for nx, and :func:`dense_z_table` for nz."""
    return (*ct_tables(nx, inverse), dense_z_table(nz, inverse))


# K8's radix route, n -> (R, M): n = R·M with M ∈ {8, 16}, a column of n
# complex values a thread in registers: the lengths whose column fits
# without spills (ptxas -v; 80 and 96 spill); every other length in 2..96
# takes the z pass
LEAD_RADIX = {8: (1, 8), 16: (1, 16), 24: (3, 8), 32: (2, 16), 40: (5, 8), 48: (3, 16), 64: (4, 16)}


def leading_route(n: int) -> str:
    """Which kernel K8 launches for a length n in 2..96: ``"radix"``
    (``dft_lead_radix``) or ``"z"`` (K10's z pass)."""
    if not supported_dense_axis(n):
        raise ValueError(f"dft_leading: length {n} is outside 2..96")
    return "radix" if n in LEAD_RADIX else "z"


def lead_radix_table(n: int, inverse: bool) -> np.ndarray:
    """K8's radix table for n = R·M (complex64, R·M + R·R entries): the
    inter-stage twiddle W_n^(j1·k1) at j1·M + k1, then the R-point DFT
    W_R^(j1·k2) at R·M + j1·R + k2, conjugated and scaled by 1/n for the
    inverse."""
    r, m = LEAD_RADIX[n]
    sign = +1.0 if inverse else -1.0
    tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(m)) / n)
    wr = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    if inverse:
        wr = wr / n
    return np.concatenate([tw.ravel(), wr.ravel()]).astype(np.complex64)


@lru_cache(maxsize=None)
def _consts_dense(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    sign = +1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    if inverse:
        w = w / n
    return w.astype(np.complex64)


_device_consts: dict = {}


def _on_device(kind: str, n, inverse: bool, device) -> tuple[torch.Tensor, ...]:
    """The constant tables of ``kind`` ("radix" (K6, K7, K9), "lead" (K8)
    for a length n, "zx" for n = (nz, nx)) as complex64 tensors on
    ``device`` (interleaved (re, im) float pairs, as the kernels read
    them), uploaded once."""
    key = (kind, n, inverse, str(device))
    if key not in _device_consts:
        if kind == "radix":
            tables = ct_tables(n, inverse)
        elif kind == "zx":
            tables = zx_tables(*n, inverse)
        elif leading_route(n) == "radix":
            tables = (lead_radix_table(n, inverse),)
        else:
            tables = (dense_z_table(n, inverse),)
        _device_consts[key] = tuple(
            to_device(np.ascontiguousarray(t), device) for t in tables
        )
    return _device_consts[key]


# --------------------------------------------------------- plain versions
def axis_plain(xr, xi, axis: int, inverse: bool, real_output: bool):
    """One axis of the transform with ``torch.fft``, in this module's
    spectrum order; ``(yr, None)`` for an inverse with ``real_output``."""
    z = torch.complex(xr, xi) if xi is not None else xr.to(torch.complex64)
    perm = scramble_perm(int(xr.shape[axis]))
    permuted = not np.array_equal(perm, np.arange(len(perm)))
    if inverse:
        if permuted:
            z = z.index_select(axis, to_device(np.argsort(perm), z.device))
        z = torch.fft.ifft(z, dim=axis)
    else:
        z = torch.fft.fft(z, dim=axis)
        if permuted:
            z = z.index_select(axis, to_device(perm, z.device))
    yi = None if (inverse and real_output) else z.imag.contiguous()
    return z.real.contiguous(), yi


def dft_trailing_plain(xr, xi=None, *, inverse=False, real_output=False):
    return axis_plain(xr, xi, 1, inverse, real_output)


def dft_middle_plain(xr, xi=None, *, inverse=False, real_output=False):
    return axis_plain(xr, xi, 1, inverse, real_output)


def dft_leading_plain(xr, xi=None, *, inverse=False, real_output=False):
    return axis_plain(xr, xi, 0, inverse, real_output)


def dft_zx_plain(xr, xi=None, *, inverse=False, real_output=False):
    if inverse:
        yr, yi = axis_plain(xr, xi, 0, True, False)
        return axis_plain(yr, yi, 2, True, real_output)
    yr, yi = axis_plain(xr, xi, 2, False, False)
    return axis_plain(yr, yi, 0, False, False)


def dft_mid_conv_plain(xr, xi, hr, hi):
    """K9's plain version: forward y DFT, product with the OTF, inverse."""
    fr, fi = axis_plain(xr, xi, 1, False, False)
    gr = fr * hr - fi * hi
    gi = fr * hi + fi * hr
    return axis_plain(gr, gi, 1, True, False)


# --------------------------------------------------------- CUDA wrappers
def _check_pair(xr, xi, ndim: int, what: str) -> None:
    if xr.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {xr.device}")
    if xr.ndim != ndim:
        raise ValueError(f"{what} takes a {ndim}D pair, got shape {tuple(xr.shape)}")
    for name, t in (("xr", xr), ("xi", xi)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != xr.device or t.shape != xr.shape:
            raise ValueError(f"{what}: xr and xi differ in device or shape")


def _outputs(xr, real_only: bool):
    yr = torch.empty_like(xr)
    return yr, (None if real_only else torch.empty_like(xr))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launched(status: int, name: str) -> None:
    """Raise on a failed launch, else count it as ``launch.<name>``."""
    _build.check(status, name)
    count("launch." + name)


def dft_trailing_cuda(xr, xi=None, *, inverse=False, real_output=False):
    """K6 on CUDA tensors; same contract as :func:`dft_trailing`."""
    _check_pair(xr, xi, 2, "dft_trailing")
    rows, n = xr.shape
    if not supported_ct_axis(n):
        raise ValueError(f"dft_trailing: length {n} is not n1*128 with 2 <= n1 <= 24")
    w1, tw, w128 = _on_device("radix", n, bool(inverse), xr.device)
    yr, yi = _outputs(xr, inverse and real_output)
    status = _build.kernels().dft_trailing_f32(
        xr.data_ptr(), _ptr(xi), yr.data_ptr(), _ptr(yi), w1.data_ptr(), tw.data_ptr(),
        w128.data_ptr(), rows, n // _LANE, int(bool(inverse)), int(bool(real_output)),
        _build.stream_handle(xr.device),
    )
    _launched(status, "dft_trailing")
    return yr, yi


def dft_middle_cuda(xr, xi=None, *, inverse=False, real_output=False):
    """K7 on CUDA tensors; same contract as :func:`dft_middle`. One call
    is two launches (the n1-point pass, then the 128-point FFTs in place;
    inverse: the FFTs, then the synthesis in place), counted once."""
    _check_pair(xr, xi, 3, "dft_middle")
    nz, n, nx = xr.shape
    if not supported_ct_axis(n) or nx % _LANE != 0:
        raise ValueError(f"dft_middle: shape {tuple(xr.shape)} needs n1*128 on axis 1, x % 128 == 0")
    w1, tw, w128 = _on_device("radix", n, bool(inverse), xr.device)
    # the inverse's intermediate is complex: yi is its scratch when only
    # the real output is kept
    yr, yi = _outputs(xr, False)
    status = _build.kernels().dft_middle_f32(
        xr.data_ptr(), _ptr(xi), yr.data_ptr(), yi.data_ptr(), w1.data_ptr(), tw.data_ptr(),
        w128.data_ptr(), nz, n // _LANE, nx, int(bool(inverse)), int(bool(inverse and real_output)),
        _build.stream_handle(xr.device),
    )
    _launched(status, "dft_middle")
    return yr, (None if (inverse and real_output) else yi)


def dft_leading_cuda(xr, xi=None, *, inverse=False, real_output=False):
    """K8 on CUDA tensors; same contract as :func:`dft_leading`. One
    launch, of the kernel :func:`leading_route` names for the length."""
    _check_pair(xr, xi, 3, "dft_leading")
    n = xr.shape[0]
    route = leading_route(n)
    (w,) = _on_device("lead", n, bool(inverse), xr.device)
    radix = LEAD_RADIX[n][1] if route == "radix" else 0  # 0: the z pass, rows of w.shape[-1]
    yr, yi = _outputs(xr, inverse and real_output)
    status = _build.kernels().dft_leading_f32(
        xr.data_ptr(), _ptr(xi), yr.data_ptr(), _ptr(yi), w.data_ptr(), n, radix, w.shape[-1],
        xr[0].numel(), int(bool(inverse)), _build.stream_handle(xr.device),
    )
    _launched(status, f"dft_leading.{route}")
    return yr, yi


def dft_zx_cuda(xr, xi=None, *, inverse=False, real_output=False):
    """K10 on CUDA tensors; same contract as :func:`dft_zx`. One call is
    two launches (x pass, z pass; inverse: z, then x), counted once."""
    _check_pair(xr, xi, 3, "dft_zx")
    nz, ny, nx = xr.shape
    if not (supported_dense_axis(nz) and supported_ct_axis(nx)):
        raise ValueError(f"dft_zx: shape {tuple(xr.shape)} needs z in 2..96 and x = n1*128")
    w1, tw, w128, wz = _on_device("zx", (nz, nx), bool(inverse), xr.device)
    # the inverse's intermediate (after its z pass) is complex: yi is its
    # scratch when only the real output is kept
    yr, yi = _outputs(xr, False)
    status = _build.kernels().dft_zx_f32(
        xr.data_ptr(), _ptr(xi), yr.data_ptr(), yi.data_ptr(), w1.data_ptr(), tw.data_ptr(),
        w128.data_ptr(), wz.data_ptr(), nz, wz.shape[1], ny, nx // _LANE, int(bool(inverse)),
        int(bool(inverse and real_output)), _build.stream_handle(xr.device),
    )
    _launched(status, "dft_zx")
    return yr, (None if (inverse and real_output) else yi)


def dft_mid_conv_cuda(xr, xi, hr, hi):
    """K9 on CUDA tensors; same contract as :func:`dft_mid_conv`. One call
    is three launches (K7's pass A forward, the conv pass, pass A
    inverse), counted once. The kernel takes any Cooley-Tukey y length
    with x a multiple of 128; :func:`mid_conv_supported`, the reference's
    gate, decides where the convolution takes it."""
    _check_pair(xr, xi, 3, "dft_mid_conv")
    _check_pair(hr, hi, 3, "dft_mid_conv")
    if hi is None or hr.shape != xr.shape or hr.device != xr.device:
        raise ValueError("dft_mid_conv: the OTF must be a complex pair of the input's shape and device")
    nz, n, nx = xr.shape
    if not supported_ct_axis(n) or nx % _LANE != 0:
        raise ValueError(f"dft_mid_conv: shape {tuple(xr.shape)} needs n1*128 on axis 1, x % 128 == 0")
    fwd = _on_device("radix", n, False, xr.device)
    inv = _on_device("radix", n, True, xr.device)
    yr, yi = _outputs(xr, False)
    status = _build.kernels().dft_mid_conv_f32(
        xr.data_ptr(), _ptr(xi), hr.data_ptr(), hi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        *(t.data_ptr() for t in fwd), *(t.data_ptr() for t in inv), nz, n // _LANE, nx,
        _build.stream_handle(xr.device),
    )
    _launched(status, "dft_mid_conv")
    return yr, yi


# ------------------------------------------------------------ entry points
def _dispatch(cuda_fn, plain_fn, xr, xi, inverse, real_output):
    if xr.device.type == "cuda":
        return cuda_fn(xr, xi, inverse=inverse, real_output=real_output)
    if xr.device.type != "cpu":
        raise ValueError(f"unsupported device {xr.device}")
    return plain_fn(xr, xi, inverse=inverse, real_output=real_output)


def dft_trailing(xr, xi=None, *, inverse=False, real_output=False):
    """DFT along the last axis of a 2D (rows, n) pair (K6). Returns
    ``(yr, yi)``; ``yi`` is None for an inverse with ``real_output``."""
    return _dispatch(dft_trailing_cuda, dft_trailing_plain, xr, xi, inverse, real_output)


def dft_middle(xr, xi=None, *, inverse=False, real_output=False):
    """DFT along axis 1 of a 3D (z, n, x) pair (K7)."""
    return _dispatch(dft_middle_cuda, dft_middle_plain, xr, xi, inverse, real_output)


def dft_leading(xr, xi=None, *, inverse=False, real_output=False):
    """Dense DFT along axis 0 of a 3D (n, y, x) pair, natural order (K8)."""
    return _dispatch(dft_leading_cuda, dft_leading_plain, xr, xi, inverse, real_output)


def dft_zx(xr, xi=None, *, inverse=False, real_output=False):
    """DFT along axes 0 and 2 of a 3D pair in one pass (K10); the inverse
    takes the z axis first and the x axis last, so ``real_output``
    applies to x."""
    return _dispatch(dft_zx_cuda, dft_zx_plain, xr, xi, inverse, real_output)


def dft_mid_conv(xr, xi, hr, hi):
    """``idft_y(dft_y(x) · h)`` along axis 1 of a 3D pair in one pass
    (K9); ``h`` is a full-spectrum OTF pair in :func:`.fftutils.fftn_spec`
    order, whose axis-1 layout is this kernel's. The caller checked
    :func:`mid_conv_supported`. Returns ``(yr, yi)``."""
    if xr.device.type == "cuda":
        return dft_mid_conv_cuda(xr, xi, hr, hi)
    if xr.device.type != "cpu":
        raise ValueError(f"unsupported device {xr.device}")
    return dft_mid_conv_plain(xr, xi, hr, hi)


def dft_axis_3d(xr, xi, axis: int, *, inverse=False, real_output=False):
    """DFT along ``axis`` of a 3D pair; the caller checked
    :func:`axis_supported`."""
    axis = axis % 3
    if axis == 2:
        z, y, n = xr.shape
        yr, yi = dft_trailing(
            xr.reshape(z * y, n), None if xi is None else xi.reshape(z * y, n),
            inverse=inverse, real_output=real_output,
        )
        return yr.reshape(z, y, n), None if yi is None else yi.reshape(z, y, n)
    if axis == 1:
        return dft_middle(xr, xi, inverse=inverse, real_output=real_output)
    return dft_leading(xr, xi, inverse=inverse, real_output=real_output)
