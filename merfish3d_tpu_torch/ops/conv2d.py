"""Stride-1 SAME 2D convolution with a fused bias + activation (counterpart
of ``merfish3d_tpu/ops/conv2d.py``): K11, every convolution of the U-FISH
U-Net.

Activations are NHWC and weights HWIO, the JAX layout, kept at this public
function. The operands run in their own type (bf16 for the U-Net, or f32),
every sum in f32; the epilogue adds the f32 bias, applies the activation
(``none``, ``relu``, ``sigmoid``) in f32 and rounds once to the output
type. SAME pads ``lo = (k - 1) // 2`` before and the rest after on each
axis, as Flax does: a 2x2 kernel takes 0 before and 1 after.

:func:`conv2d_same` launches a hand-written kernel on a CUDA tensor, for
any Cin and Co and kernels up to 3x3, and runs its plain version
(:func:`conv2d_same_plain`) on a CPU tensor. bf16 operands take the
tensor-core kernel (``csrc/conv2d_mma.cu``), an implicit GEMM over the
weights that :func:`pack_weights` lays out once; f32 operands take the
FP32-core kernel (``csrc/conv2d.cu``). The reference's lane-packed layout
and its shape gate exist for the TPU's 128-lane matrix unit and are not
carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
import torch.nn.functional as F

from .. import _build
from ..utils.profiling import count

ACTS = {"none": 0, "relu": 1, "sigmoid": 2}
_COT = 16  # output channels a block of the f32 kernel (csrc/conv2d.cu)
_MAX_GRID_Z = 65535
K_SLICE = 16  # input channels a K slice of the tensor-core kernel
# the tensor-core kernel's output-channel blocks, and each one's tile of
# output pixels (rows, columns) a block (csrc/conv2d_mma.cu ``Cfg``)
TILES = {16: (8, 64), 32: (8, 64), 64: (8, 32), 128: (8, 16)}

def same_pads(k: int) -> tuple[int, int]:
    """(before, after) of SAME padding for a stride-1 kernel of size k."""
    lo = (int(k) - 1) // 2
    return lo, int(k) - 1 - lo


@dataclass(frozen=True)
class PackedWeights:
    """HWIO weights in bf16 beside the tensor-core kernel's layout of them:
    ``data`` is (ceil(Co / nb), ceil(Cin / 16), kh * kw, nb, 16) bf16, K
    ordered (tap, input channel) and zero-padded in Cin and Co, so that one
    (N half, slice) stage of the kernel is one contiguous copy."""

    hwio: torch.Tensor
    data: torch.Tensor

    @property
    def n_block(self) -> int:
        return int(self.data.shape[3])


def n_block(co: int) -> int:
    """The tensor-core kernel's output-channel block for Co channels: the
    smallest of 16, 32, 64, 128 that holds them; wider layers walk
    ceil(Co / 128) halves of 128 inside the block."""
    return next((nb for nb in TILES if co <= nb), 128)


def pack_weights(w: torch.Tensor) -> PackedWeights:
    """(kh, kw, Cin, Co) weights -> :class:`PackedWeights` on ``w``'s
    device, rounded to bf16 once."""
    kh, kw, cin, co = (int(v) for v in w.shape)
    hwio = w.to(torch.bfloat16).contiguous()
    nb = n_block(co)
    halves, slices = -(-co // nb), -(-cin // K_SLICE)
    padded = torch.zeros((kh * kw, slices * K_SLICE, halves * nb), dtype=torch.bfloat16, device=w.device)
    padded[:, :cin, :co] = hwio.reshape(kh * kw, cin, co)
    # [tap, s*16 + k, h*nb + o] -> [h, s, tap, o, k]
    data = padded.reshape(kh * kw, slices, K_SLICE, halves, nb).permute(3, 1, 0, 4, 2).contiguous()
    return PackedWeights(hwio, data)


Weights = Union[torch.Tensor, PackedWeights]


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act != "none":
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return y


def conv2d_same_plain(x, w: Weights, b, *, act: str = "none", out_dtype=None):
    """K11's plain version: ``F.conv2d`` on float32 copies of the operands
    as given (already rounded to their type), explicit asymmetric SAME
    padding, then the f32 bias, the activation and one cast."""
    if isinstance(w, PackedWeights):
        w = w.hwio
    out_dtype = out_dtype or x.dtype
    kh, kw = int(w.shape[0]), int(w.shape[1])
    (top, bottom), (left, right) = same_pads(kh), same_pads(kw)
    xf = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xf, w.float().permute(3, 2, 0, 1))
    y = _activate(y + b.float()[None, :, None, None], act)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def conv2d_same_cuda(x, w: Weights, b, *, act: str = "none", out_dtype=None):
    """K11 on CUDA tensors: ``x`` (N, H, W, Cin) contiguous; ``w`` (kh, kw,
    Cin, Co) in ``x``'s type, or, for bf16, already packed
    (:func:`pack_weights`); ``b`` (Co,) f32. bf16 operands go through the
    tensor-core kernel and give bf16 or f32; f32 operands through the
    FP32-core kernel and give f32."""
    out_dtype = out_dtype or x.dtype
    packed = w if isinstance(w, PackedWeights) else None
    hwio = packed.hwio if packed is not None else w
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_same_cuda needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or hwio.dtype != x.dtype:
        raise TypeError(f"conv2d_same_cuda: operands must be both bf16 or both f32, got {x.dtype}, {hwio.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"conv2d_same_cuda: {x.dtype} operands give {x.dtype} or f32, not {out_dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"conv2d_same_cuda: the bias must be f32, got {b.dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.ndim != 4 or hwio.ndim != 4 or hwio.shape[2] != x.shape[3] or b.shape != (hwio.shape[3],):
        raise ValueError(f"conv2d_same_cuda: shapes x {tuple(x.shape)}, w {tuple(hwio.shape)}, b {tuple(b.shape)}")
    kh, kw, cin, co = (int(v) for v in hwio.shape)
    n, h, wd, _ = (int(v) for v in x.shape)
    if not (1 <= kh <= 3 and 1 <= kw <= 3):
        raise ValueError(f"conv2d_same_cuda: kernels up to 3x3, got {kh}x{kw}")
    if x.dtype == torch.bfloat16:
        if packed is None:
            packed = pack_weights(hwio)
        wt = packed.data
        if n > _MAX_GRID_Z:
            raise ValueError(f"conv2d_same_cuda: {n} planes exceed one launch")
    else:
        wt = hwio
        if n * -(-co // _COT) > _MAX_GRID_Z:
            raise ValueError(f"conv2d_same_cuda: {n} planes x {co} channels exceed one launch")
    for t in (x, wt, b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv2d_same_cuda: inputs must be contiguous and on one device")
    y = torch.empty((n, h, wd, co), dtype=out_dtype, device=x.device)
    lib = _build.kernels()
    stream = _build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        status = lib.conv2d_same_mma_bf16(x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
                                          int(out_dtype == torch.float32), n, h, wd, cin, co, kh, kw,
                                          packed.n_block, ACTS[act], stream)
        _build.check(status, "conv2d_same_mma_bf16")
        count("launch.conv2d_same_mma_bf16")
    else:
        status = lib.conv2d_same_f32(x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
                                     n, h, wd, cin, co, kh, kw, ACTS[act], stream)
        _build.check(status, "conv2d_same_f32")
        count("launch.conv2d_same_f32")
    return y


def conv2d_same(x, w: Weights, b, *, act: str = "none", out_dtype=None):
    """Stride-1 SAME convolution, (N, H, W, Cin) x (kh, kw, Cin, Co) ->
    (N, H, W, Co), with ``act(conv + b)`` rounded once to ``out_dtype``
    (default: ``x``'s type). ``w`` is HWIO, cast to ``x``'s type, or
    :class:`PackedWeights` for bf16 ``x``; ``b`` is cast to f32. K11 on a
    CUDA tensor, its plain version on a CPU tensor."""
    if not isinstance(w, PackedWeights):
        w = torch.as_tensor(w, device=x.device).to(x.dtype).contiguous()
    elif x.dtype != torch.bfloat16:
        raise TypeError(f"conv2d_same: packed weights are bf16, the input is {x.dtype}")
    b = torch.as_tensor(b, device=x.device).to(torch.float32).contiguous()
    if x.device.type == "cuda":
        return conv2d_same_cuda(x.contiguous(), w, b, act=act, out_dtype=out_dtype)
    return conv2d_same_plain(x, w, b, act=act, out_dtype=out_dtype)
