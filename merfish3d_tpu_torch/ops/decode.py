"""Per-pixel MERFISH nearest-codeword decoding (counterpart of
``merfish3d_tpu/ops/decode.py``).

Traces and codewords are both L2-normalized, so the Euclidean nearest
codeword is ``argmax(t · c)`` with ``dist = sqrt(2 - 2 max(t · c))``.

:func:`decode_chunk` dispatches on the device of its input: a CUDA
tensor launches kernel K3 (``csrc/decode.cu``), a CPU tensor runs
:func:`decode_chunk_plain`, the same arithmetic in plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count, to_device, to_host
from .device import as_device_tensor

def normalize_codebook(codebook_matrix: np.ndarray) -> np.ndarray:
    """L2-normalize codeword rows (reference `_normalize_codebook:585-639`)."""
    cb = np.asarray(codebook_matrix, dtype=np.float32)
    norm = np.linalg.norm(cb, axis=1, keepdims=True)
    return cb / np.maximum(norm, 1e-12)


def caller_thresholds(on_bits_median: int) -> tuple[float, float]:
    """Two-threshold MERFISH caller constants from the median on-bit
    count B. Returns (pixel_assignment_threshold,
    transcript_distance_threshold)."""
    b = float(on_bits_median)
    pixel = np.sqrt(2.0 - 2.0 * (b - 2.0) / np.sqrt(b * (b - 2.0)))
    transcript = np.sqrt(2.0 - 2.0 * b / np.sqrt(b * (b + 2.0)))
    return float(pixel), float(transcript)


def decode_chunk_plain(traces, codebook_t, background, normalization, *, want_scaled=True):
    """traces (bits, N) f32; codebook_t (bits, words) L2-normalized.
    Returns (best i32, dist f32, mag f32, scaled f32 (bits, N) or None)."""
    scaled = ((traces - background[:, None]) / normalization[:, None]).clamp(0.0, 1.0)
    mag = torch.sqrt(torch.sum(scaled * scaled, dim=0))
    unit = scaled / torch.clamp(mag, min=1e-12)[None, :]
    sims = codebook_t.T @ unit
    max_sim, best = torch.max(sims, dim=0)  # first index of the maximum
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * max_sim, min=0.0))
    return best.to(torch.int32), dist, mag, scaled if want_scaled else None


def voxels_per_thread(bits: int) -> int:
    """V, the voxels a thread of K2 or K3 decodes (``csrc/decode_core.cuh``):
    4 while a trace fits 16 registers, else 2."""
    return 4 if bits <= 16 else 2


def pack_codebook(codebook_t: torch.Tensor) -> torch.Tensor:
    """The (words, bits_p) codebook K2 and K3 read as float4 groups:
    ``codebook_t.T`` with bits padded by exact zeros to ``bits_p``, the next
    multiple of 4. The kernels' padded traces are zero as well, so the pad
    adds fmaf(0, 0, s) == s to every sum."""
    bits, words = codebook_t.shape
    packed = torch.zeros((words, -(-bits // 4) * 4), dtype=torch.float32, device=codebook_t.device)
    packed[:, :bits] = codebook_t.T
    return packed


def check_decode_inputs(traces, codebook_t, background, normalization) -> None:
    """Raise on anything kernel K3 does not take. ``traces`` may be a view
    whose rows lie any distance apart (a z-chunk of a (bits, Z, Y, X)
    volume), as long as each row is contiguous."""
    if traces.ndim != 2 or not 1 <= traces.shape[0] <= 32:
        raise ValueError(f"traces must be (bits<=32, N), got {tuple(traces.shape)}")
    if traces.shape[1] > 1 and traces.stride(1) != 1:
        raise ValueError("traces rows must each be contiguous")
    bits = traces.shape[0]
    for name, t, shape in (
        ("traces", traces, None),
        ("codebook_t", codebook_t, None),
        ("background", background, (bits,)),
        ("normalization", normalization, (bits,)),
    ):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != traces.device:
            raise ValueError(f"{name} is on {t.device}, traces on {traces.device}")
        if name != "traces" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if codebook_t.ndim != 2 or codebook_t.shape[0] != bits or codebook_t.shape[1] < 1:
        raise ValueError(f"codebook_t must be ({bits}, words), got {tuple(codebook_t.shape)}")
    if (codebook_t.shape[1] + 2) * bits * 4 > 48 * 1024:
        raise ValueError("codebook too large for the kernels: (words + 2) * bits * 4 B > 48 KB")


def decode_chunk_cuda(traces, codebook_t, background, normalization, *, want_scaled=True):
    """Kernel K3 on a CUDA tensor; same contract as :func:`decode_chunk_plain`."""
    if traces.device.type != "cuda":
        raise ValueError("decode_chunk_cuda needs CUDA tensors")
    check_decode_inputs(traces, codebook_t, background, normalization)
    bits, n = traces.shape
    lib = _build.kernels()
    cb = pack_codebook(codebook_t)
    dev = traces.device
    best = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    mag = torch.empty(n, dtype=torch.float32, device=dev)
    scaled = torch.empty((bits, n), dtype=torch.float32, device=dev) if want_scaled else None
    status = lib.decode_chunk_f32(
        traces.data_ptr(), cb.data_ptr(), background.data_ptr(),
        normalization.data_ptr(), bits, cb.shape[0], n, traces.stride(0), best.data_ptr(),
        dist.data_ptr(), mag.data_ptr(),
        scaled.data_ptr() if scaled is not None else None,
        _build.stream_handle(traces.device),
    )
    _build.check(status, "decode_chunk_f32")
    count("launch.decode_chunk_f32")
    return best, dist, mag, scaled


def decode_chunk(traces, codebook_t, background, normalization, *, want_scaled=True):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    if traces.device.type == "cuda":
        return decode_chunk_cuda(
            traces, codebook_t, background, normalization, want_scaled=want_scaled
        )
    if traces.device.type != "cpu":
        raise ValueError(f"unsupported device {traces.device}")
    check_decode_inputs(traces, codebook_t, background, normalization)
    return decode_chunk_plain(
        traces, codebook_t, background, normalization, want_scaled=want_scaled
    )


def decode_planes(
    bit_planes: torch.Tensor,  # (bits, P, Y, X) float32, already lowpassed
    codebook_t: torch.Tensor,  # (bits, words) normalized
    background: torch.Tensor,
    normalization: torch.Tensor,
    *,
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float = 0.5172,
    return_scaled: bool = True,
):
    """Decode a block of z-planes. Returns (decoded int16 [-1 unassigned],
    magnitude f16, distance f16, scaled f16 or None) shaped like the
    spatial dims, as tensors on the input's device."""
    bits = bit_planes.shape[0]
    chunk = decode_chunk(
        bit_planes.reshape(bits, -1), codebook_t, background, normalization,
        want_scaled=return_scaled,
    )
    return assign_pixels(
        *chunk, bit_planes.shape,
        magnitude_threshold=magnitude_threshold,
        distance_threshold=distance_threshold,
    )


def assign_pixels(best, dist, mag, scaled, shape, *, magnitude_threshold, distance_threshold):
    """Threshold a decoded chunk and shape it like ``shape = (bits, *spatial)``:
    (decoded int16 [-1 unassigned], magnitude f16, distance f16, scaled f16
    or None)."""
    bits, spatial = shape[0], tuple(shape[1:])
    lo, hi = magnitude_threshold
    assigned = (dist <= distance_threshold) & (mag >= lo) & (mag <= hi)
    decoded = torch.where(assigned, best, -1).to(torch.int16)
    return (
        decoded.reshape(spatial),
        mag.to(torch.float16).reshape(spatial),
        dist.to(torch.float16).reshape(spatial),
        None if scaled is None else scaled.to(torch.float16).reshape(bits, *spatial),
    )


def output_sink(dev: torch.device, on_device: bool):
    """``(empty, put)`` for assembling a decode's outputs piece by piece:
    ``empty(shape, dtype_name)`` allocates an output and ``put(t)`` turns a
    device piece into what is stored in it. With ``on_device`` the outputs
    are tensors on ``dev`` and the pieces stay there, else host numpy
    arrays and the pieces are downloaded."""
    if not on_device:
        return np.empty, to_host

    def empty(shape, dtype: str):
        return torch.empty(shape, dtype=getattr(torch, dtype), device=dev)

    return empty, lambda t: t


def decode_volume(
    bit_volume,  # (bits, Z, Y, X) tensor or array
    codebook_matrix: np.ndarray,  # (words, bits) raw 0/1
    background,
    normalization,
    *,
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float,
    z_chunk: int = 8,
    return_scaled: bool = True,
    device=None,
    on_device: bool = False,
):
    """Decode a tile volume in z-chunks (device memory bounded by
    ``bits × z_chunk × Y × X`` per launch). A float32 volume's chunks go to K3
    as views, without a copy. Returns host numpy arrays
    (decoded int16, magnitude f16, distance f16, scaled f16 or None), as
    the reference does; with ``on_device`` the same four as tensors on the
    decode's device, and nothing is downloaded. ``device`` defaults to the
    input tensor's, and to ``cuda`` for a host array."""
    vol = as_device_tensor(bit_volume, device)
    dev = vol.device
    cb_t = to_device(normalize_codebook(codebook_matrix).T.copy(), dev)
    bg = to_device(np.asarray(background, np.float32), dev)
    norm = to_device(np.asarray(normalization, np.float32), dev)
    bits, nz, ny, nx = vol.shape
    empty, put = output_sink(dev, on_device)
    decoded = empty((nz, ny, nx), "int16")
    mag = empty((nz, ny, nx), "float16")
    dist = empty((nz, ny, nx), "float16")
    scaled = empty((bits, nz, ny, nx), "float16") if return_scaled else None
    for z0 in range(0, nz, z_chunk):
        z1 = min(z0 + z_chunk, nz)
        d, m, di, sc = decode_planes(
            vol[:, z0:z1].to(torch.float32), cb_t, bg, norm,
            magnitude_threshold=tuple(magnitude_threshold),
            distance_threshold=float(distance_threshold),
            return_scaled=return_scaled,
        )
        decoded[z0:z1] = put(d)
        mag[z0:z1] = put(m)
        dist[z0:z1] = put(di)
        if scaled is not None:
            scaled[:, z0:z1] = put(sc)
    return decoded, mag, dist, scaled
