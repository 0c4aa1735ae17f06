"""The least work of the U-FISH network, for ``ufish_roofline``.

The network is a configuration's ``decode.predictor_weights`` topology
(``base_features``, ``depths``, and the ConvTranspose decoder of the
published ufish_c32 family; the port's ``UFishNet`` and the plain
``reference/ufish.py`` follow it) at the padded plane H × W, widths
f_i = base · depth_i, one level a halving of the plane. Only the
convolutions count: the two 3×3 SAME convolutions of every block, the
decoder's up-projections (a ConvTranspose 2×2, stride 2, as a 1×1
convolution to 4·Co channels) and the 1×1 sigmoid head. Each (kh × kw,
Cin → Co) does 2 · H·W · kh·kw·Cin·Co flops, reads its bf16 input once
and writes its bf16 output once a plane, and reads its bf16 kernel and
f32 bias once a call.

The pools, the concatenations and the depth-to-space are layout moves
that a network fused across them need not make (a block's first
convolution can read the skip and the up-projection as two inputs, an
up-projection can write in the depth-to-space layout, a pool can be read
from the skip), so they count nothing; their device time shows in the
traced run's breakdown. The epilogues (bias, ReLU, sigmoid) count no
flops. The least time is, summed over the convolutions, the larger of
flops over the bf16 tensor-core peak and bytes over the HBM rate (one
NVIDIA H100 SXM at 700 W, NVIDIA's data sheet, dense).
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

BF16_FLOP_PER_S = 989.4e12
BF16, F32 = 2, 4


def network_ops(spec: dict, height: int, width: int) -> list[tuple[str, float, float, float]]:
    """``(name, flops a plane, activation bytes a plane, weight bytes a
    call)`` of every convolution of the network ``spec`` on one padded
    ``height`` × ``width`` plane, in the order the network runs them."""
    f = [int(spec["base_features"]) * int(d) for d in spec["depths"]]
    levels = len(f)
    if height % 2 ** (levels - 1) or width % 2 ** (levels - 1):
        raise ValueError(f"a {height}x{width} plane does not halve {levels - 1} times")
    if spec["up_mode"] != "convtranspose":
        raise ValueError(f"the least work is counted for the ConvTranspose decoder, not {spec['up_mode']!r}")
    ops = []

    def area(level):
        return (height >> level) * (width >> level)

    def conv(name, level, k, cin, co):
        n = area(level)
        weights = BF16 * k * k * cin * co + F32 * co
        ops.append((name, 2.0 * n * k * k * cin * co, float(BF16 * n * (cin + co)), float(weights)))

    def block(i, level, cin, co):
        conv(f"block{i}.conv0", level, 3, cin, co)
        conv(f"block{i}.conv1", level, 3, co, co)

    for i in range(levels):
        block(i, i, 1 if i == 0 else f[i - 1], f[i])
    for j in range(levels - 1):
        deep, level = levels - 1 - j, levels - 2 - j
        cin, co = f[deep], f[level]
        conv(f"up{j}", deep, 1, cin, 4 * co)
        block(levels + j, level, 2 * co, co)
    conv("head", 0, 1, f[0], 1)
    return ops


def least_seconds(spec: dict, planes: int, height: int, width: int) -> float:
    """The least time of one network call on ``planes`` padded planes."""
    return sum(max(flops * planes / BF16_FLOP_PER_S, (act * planes + weights) / HBM_BYTES_PER_S)
               for _, flops, act, weights in network_ops(spec, height, width))
