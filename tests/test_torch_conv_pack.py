"""A CPU model of K11's tensor-core decomposition (csrc/conv2d_mma.cu).

The card's kernel cannot run here, so its arithmetic is held through a
torch emulation of its loop, driven by the packed weights that the wrapper
uploads (``ops.conv2d.pack_weights``): for each block's tile of output
pixels (``ops.conv2d.TILES``) the input tile with its halo, zero outside
the image and past Cin; for each N half, K walked as 16-channel slices,
each slice taking every tap, products of bf16 values summed in f32; then
the epilogue (f32 bias, activation, one rounding) on the pixels and
channels inside the output. The emulation is held to K11's plain version
(``conv2d_same_plain``): f32 outputs within 2e-5 x max|y| (the same exact
products, summed in another order), bf16 outputs within one bf16 rounding
step (plus 2**-20 x max|y| near zero). The shapes are every card case of
``tests/test_torch_cuda.py`` and the c32 and c8 U-Nets' layer kinds at
small spatial sizes, with ragged tiles.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from merfish3d_tpu_torch.models import ufish as tufish
from merfish3d_tpu_torch.ops import conv2d as c2
from test_torch_cuda import _K11_CASES, _within_one_bf16_step

_EXTRA_CASES = [
    ((1, 20, 36, 128), (3, 3, 128, 64), "relu"),  # c32 decoder's first 3x3
    ((1, 18, 70, 1), (3, 3, 1, 32), "relu"),  # c32's first conv: Cin = 1
    ((1, 18, 70, 32), (1, 1, 32, 1), "sigmoid"),  # c32's head: Co = 1
    ((1, 17, 33, 16), (2, 2, 16, 8), "none"),  # c8's 2x2 decoder conv, ragged tiles
    ((1, 9, 70, 12), (1, 3, 12, 40), "relu"),  # a 1x3 kernel, Co padded to 64
    ((2, 9, 17, 64), (3, 1, 64, 130), "none"),  # a 3x1 kernel, a second N half of 2
]


def emulate(x: torch.Tensor, packed: c2.PackedWeights, b: torch.Tensor, act: str, out_dtype):
    """K11's tensor-core loop on the CPU, block by block (see the module
    docstring)."""
    kh, kw, cin, co = packed.hwio.shape
    halves, slices, taps, nb, ks = packed.data.shape
    assert (taps, ks) == (kh * kw, c2.K_SLICE)
    th, tw = c2.TILES[nb]
    (lo_h, _), (lo_w, _) = c2.same_pads(kh), c2.same_pads(kw)
    n, h, w, _ = x.shape
    ty, tx = -(-h // th), -(-w // tw)
    # what the blocks' halo tiles read: zero outside the image and past Cin
    src = torch.zeros((n, ty * th + kh - 1, tx * tw + kw - 1, slices * ks))
    src[:, lo_h : lo_h + h, lo_w : lo_w + w, :cin] = x.float()
    wk = packed.data.float()
    out = torch.empty((n, h, w, co), dtype=out_dtype)
    for by in range(ty):
        for bx in range(tx):
            y0, x0 = by * th, bx * tw
            tile = src[:, y0 : y0 + th + kh - 1, x0 : x0 + tw + kw - 1]
            rows, cols = min(th, h - y0), min(tw, w - x0)
            for nh in range(halves):
                acc = torch.zeros((n, th, tw, nb))
                for s in range(slices):
                    for t in range(taps):
                        dy, dx = divmod(t, kw)
                        a = tile[:, dy : dy + th, dx : dx + tw, s * ks : (s + 1) * ks]
                        acc += a @ wk[nh, s, t].T
                o0 = nh * nb
                nv = min(nb, co - o0)
                v = c2._activate(acc[..., :nv] + b[o0 : o0 + nv], act)
                out[:, y0 : y0 + rows, x0 : x0 + cols, o0 : o0 + nv] = v[:, :rows, :cols].to(out_dtype)
    return out


def _operands(shape, kshape, seed=9):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    w = torch.as_tensor((rng.standard_normal(kshape) * 0.2).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(kshape[-1]).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,kshape,act", _K11_CASES + _EXTRA_CASES)
def test_emulated_kernel_matches_plain(shape, kshape, act, out_dtype):
    x, w, b = _operands(shape, kshape)
    packed = c2.pack_weights(w)
    got = emulate(x, packed, b, act, out_dtype)
    want = c2.conv2d_same_plain(x, packed.hwio, b, act=act, out_dtype=out_dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    if out_dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()
    else:
        assert _within_one_bf16_step(got, want)


@pytest.mark.parametrize("kshape", [(3, 3, 1, 32), (1, 1, 128, 256), (2, 2, 24, 8), (3, 1, 40, 130)])
def test_pack_layout(kshape):
    """Every weight lands at (N half, slice, tap, output in block, channel
    in slice), rounded to bf16 once; every padded place is zero."""
    kh, kw, cin, co = kshape
    w = torch.as_tensor(np.random.default_rng(4).standard_normal(kshape).astype(np.float32))
    packed = c2.pack_weights(w)
    nb = c2.n_block(co)
    assert nb == packed.n_block and nb in c2.TILES and (co <= nb or nb == 128)
    assert packed.data.shape == (-(-co // nb), -(-cin // 16), kh * kw, nb, 16)
    assert packed.data.dtype == torch.bfloat16 and packed.data.is_contiguous()
    torch.testing.assert_close(packed.hwio, w.to(torch.bfloat16), rtol=0, atol=0)
    d = packed.data.float()
    for dy, dx, c, o in np.ndindex(kh, kw, cin, co):
        assert d[o // nb, c // 16, dy * kw + dx, o % nb, c % 16] == packed.hwio[dy, dx, c, o].float()
    assert (d != 0).sum() == (packed.hwio != 0).sum()  # nothing else is non-zero


def test_prepared_net_runs_like_the_cast_weights():
    """The U-Net with its weights packed once gives the maps that casting
    the f32 weights on every call gives; the predictor packs on creation."""
    variables = tufish.load_checkpoint(Path(__file__).parent / "data" / "ufish_synthetic_c8.pkl")
    pred = tufish.UFishPredictor(params=variables, device="cpu")
    convs = [m for m in pred.net.modules() if isinstance(m, tufish._Conv)]
    assert len(convs) == 13 and all(m.packed is not None for m in convs)
    x = torch.as_tensor(np.random.default_rng(2).random((2, 32, 32, 1)).astype(np.float32)).to(torch.bfloat16)
    got = pred.net(x)
    for m in convs:
        m.packed = None
    want = pred.net(x)
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="packed"):
        c2.conv2d_same(x.float(), c2.pack_weights(convs[0].weight), convs[0].bias)
