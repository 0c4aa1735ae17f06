"""Stride-1 SAME 2D convolution with a fused bias + activation (counterpart
of ``merfish3d_tpu/ops/conv2d.py``): K11, every convolution of the U-FISH
U-Net.

Activations are NHWC and weights HWIO, the JAX layout, kept at this public
function. The operands run in their own type (bf16 for the U-Net, or f32),
every sum in f32; the epilogue adds the f32 bias, applies the activation
(``none``, ``relu``, ``sigmoid``) in f32 and rounds once to the output
type. SAME pads ``lo = (k - 1) // 2`` before and the rest after on each
axis, as Flax does: a 2x2 kernel takes 0 before and 1 after.

:func:`conv2d_same` launches the hand-written kernel in
``csrc/conv2d.cu`` on a CUDA tensor, for any Cin and Co and kernels up to
3x3, and runs its plain version (:func:`conv2d_same_plain`) on a CPU
tensor. The reference's lane-packed layout and its shape gate exist for
the TPU's 128-lane matrix unit and are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

ACTS = {"none": 0, "relu": 1, "sigmoid": 2}
_COT = 16  # output channels a block (csrc/conv2d.cu)
_MAX_GRID_Z = 65535

# launches of the kernel since the last reset (chip_smoke reads it)
launch_count = 0


def same_pads(k: int) -> tuple[int, int]:
    """(before, after) of SAME padding for a stride-1 kernel of size k."""
    lo = (int(k) - 1) // 2
    return lo, int(k) - 1 - lo


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act != "none":
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return y


def conv2d_same_plain(x, w, b, *, act: str = "none", out_dtype=None):
    """K11's plain version: ``F.conv2d`` on float32 copies of the operands
    as given (already rounded to their type), explicit asymmetric SAME
    padding, then the f32 bias, the activation and one cast."""
    out_dtype = out_dtype or x.dtype
    kh, kw = int(w.shape[0]), int(w.shape[1])
    (top, bottom), (left, right) = same_pads(kh), same_pads(kw)
    xf = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xf, w.float().permute(3, 2, 0, 1))
    y = _activate(y + b.float()[None, :, None, None], act)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def conv2d_same_cuda(x, w, b, *, act: str = "none", out_dtype=None):
    """K11 on CUDA tensors: ``x`` (N, H, W, Cin) and ``w`` (kh, kw, Cin, Co)
    contiguous, both bf16 or both f32, ``b`` (Co,) f32; the output is the
    operand type, or f32 from bf16 operands."""
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_same_cuda needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"conv2d_same_cuda: operands must be both bf16 or both f32, got {x.dtype}, {w.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"conv2d_same_cuda: {x.dtype} operands give {x.dtype} or f32, not {out_dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"conv2d_same_cuda: the bias must be f32, got {b.dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3] or b.shape != (w.shape[3],):
        raise ValueError(f"conv2d_same_cuda: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    kh, kw, cin, co = (int(v) for v in w.shape)
    n, h, wd, _ = (int(v) for v in x.shape)
    if not (1 <= kh <= 3 and 1 <= kw <= 3):
        raise ValueError(f"conv2d_same_cuda: kernels up to 3x3, got {kh}x{kw}")
    if n * -(-co // _COT) > _MAX_GRID_Z:
        raise ValueError(f"conv2d_same_cuda: {n} planes x {co} channels exceed one launch")
    for t in (x, w, b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv2d_same_cuda: inputs must be contiguous and on one device")
    y = torch.empty((n, h, wd, co), dtype=out_dtype, device=x.device)
    lib = _build.kernels()
    stream = _build.stream_handle(x.device)
    dims = (n, h, wd, cin, co, kh, kw, ACTS[act])
    if x.dtype == torch.bfloat16:
        status = lib.conv2d_same_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                      int(out_dtype == torch.float32), *dims, stream)
    else:
        status = lib.conv2d_same_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), *dims, stream)
    _build.check(status, "conv2d_same")
    global launch_count
    launch_count += 1
    return y


def conv2d_same(x, w, b, *, act: str = "none", out_dtype=None):
    """Stride-1 SAME convolution, (N, H, W, Cin) x (kh, kw, Cin, Co) ->
    (N, H, W, Co), with ``act(conv + b)`` rounded once to ``out_dtype``
    (default: ``x``'s type). ``w`` is cast to ``x``'s type and ``b`` to
    f32 (both no-ops for the U-Net's prepared weights). K11 on a CUDA
    tensor, its plain version on a CPU tensor."""
    w = torch.as_tensor(w, device=x.device).to(x.dtype).contiguous()
    b = torch.as_tensor(b, device=x.device).to(torch.float32).contiguous()
    if x.device.type == "cuda":
        return conv2d_same_cuda(x.contiguous(), w, b, act=act, out_dtype=out_dtype)
    return conv2d_same_plain(x, w, b, act=act, out_dtype=out_dtype)
