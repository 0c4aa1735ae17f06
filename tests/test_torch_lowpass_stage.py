"""K1, the y and z passes of the decode lowpass, on the CPU.

(a) The port's plain version (``zy_lowpass_plain``) against the reference's
Pallas kernel alone: ``_zyconv_scan_kernel`` run in interpret mode through
``fused_lowpass_decode(..., stages=1)``, whose pass-1 output
(nz_t, ny_t, bits_p, xp) is cropped and transposed to (bits, Z, Y, X).

(b) A model of the card kernel's tiling (csrc/fused_decode.cu,
``zy_lowpass_kernel``), driven by the tables the wrapper uploads
(``_zy_tables``: the z fold, the y taps, the y pad's index map). A tile is a
bit, kZyTileX columns and a segment of SEG = kZyWarps * kZyAcc / MAXZ output
rows; tiles are numbered column tile fastest and block i of a grid walks
tiles i, i + grid, .... Each plane of a tile is staged as the kernel stages
it: padded row y0 + i from row y0 + i - r inside the volume, else from
ymap[y0 + i], in 16-byte groups (at most two a thread where nx % 4 == 0 and
the taps fit the register window), into a slot of NaN, so an output that
read a place nothing was staged into comes out NaN. Lane l of warp w sums
the y taps of rows w * R .. w * R + R - 1 in ascending tap order from +0 and
folds each into its accumulators through wz's column, planes ascending;
the tile is stored where its rows and columns lie inside the volume. The
constants are read from the kernel source.

Both within 1e-6 * max|x| (float32 sums in another order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfish3d_tpu.ops import fused_decode as jfd
from merfish3d_tpu_torch.ops import fused_decode as fd

RTOL = 1e-6
SOURCE = (Path(fd.__file__).parent.parent / "csrc" / "fused_decode.cu").read_text()


def _source_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in fused_decode.cu"
    return int(m.group(1))


WARPS, TILE_X, ACC, WINDOW = (_source_int(n) for n in ("kZyWarps", "kZyTileX", "kZyAcc", "kWindowTaps"))
THREADS = 32 * WARPS


def _volume(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 100).astype(np.float32)


def _assert_close(got, want, scale, what):
    err = (got - want).abs().max().item()
    assert err <= RTOL * scale, f"{what}: max |err| {err:.3e} > {RTOL} x {scale:.1f}"


# (bits, Z, Y, X): ragged Y and X, Y below the 4-row halo, one plane
_PALLAS_SHAPES = [(16, 5, 40, 136), (3, 16, 33, 129), (2, 1, 9, 64), (2, 4, 3, 64)]


@pytest.mark.parametrize("sigma_z", [0.0, 3.0])
@pytest.mark.parametrize("shape", _PALLAS_SHAPES)
def test_plain_matches_pallas_kernel(shape, sigma_z):
    from jax.experimental.pallas import tpu as pltpu

    bits, nz, ny, nx = shape
    vol = _volume(shape, sum(shape))
    sigma = (sigma_z, 1.0, 1.0)
    cbt = jnp.eye(bits, 4, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        zy = jfd.fused_lowpass_decode(
            jnp.asarray(vol), cbt, jnp.zeros(bits, jnp.float32), jnp.ones(bits, jnp.float32),
            sigma=sigma, stages=1,
        )
    ref = np.transpose(np.array(zy)[:nz, :ny, :bits, :nx], (2, 0, 1, 3))
    got = fd.zy_lowpass_plain(torch.as_tensor(vol), sigma)
    _assert_close(got, torch.as_tensor(ref), float(np.abs(vol).max()), "plain vs Pallas")


def zy_tiling_model(vol: torch.Tensor, sigma, grid: int) -> torch.Tensor:
    """The staged kernel's walk on a (bits, Z, Y, X) volume (see the module
    note); ``grid`` blocks."""
    bits, nz, ny, nx = vol.shape
    maxz = 16 if nz <= 16 else 32 if nz <= 32 else 64
    assert nz <= 64, "deeper volumes take the direct kernel"
    rows = ACC // maxz  # R
    seg = WARPS * rows
    tab = fd._zy_tables(nz, ny, float(sigma[0]), float(sigma[1]), torch.device("cpu"))
    wz, ky, ymap = tab.wz, tab.ky, tab.ymap.long()
    taps, r = ky.numel(), (ky.numel() - 1) // 2
    srows = seg + max(taps, WINDOW) - 1  # zy_stage_rows
    nseg, ntx = -(-ny // seg), -(-nx // TILE_X)
    ntiles = nseg * ntx * bits
    fixed = nx % 4 == 0 and taps <= WINDOW
    if fixed:  # the two 16-byte groups a thread keeps for a tile's planes
        assert (seg + WINDOW - 1) * TILE_X // 4 <= 2 * THREADS
    out = torch.full_like(vol, torch.nan)
    written = torch.zeros(vol.shape, dtype=torch.int32)
    warp_rows = (torch.arange(WARPS)[:, None] * rows + torch.arange(rows)).reshape(-1)  # w * R + r
    for block in range(min(grid, ntiles)):
        for t in range(block, ntiles, min(grid, ntiles)):
            x0, y0, b = t % ntx * TILE_X, t // ntx % nseg * seg, t // ntx // nseg
            nout, ncols = min(seg, ny - y0), min(TILE_X, nx - x0)
            nrows = nout + taps - 1
            if nx % 4 == 0:  # whole 16-byte groups only
                assert ncols % 4 == 0
            src = torch.arange(nrows) + y0 - r
            outside = (src < 0) | (src >= ny)
            src[outside] = ymap[y0 + torch.nonzero(outside).reshape(-1)]
            acc = torch.zeros((nz, WARPS * rows, TILE_X))
            for z in range(nz):  # planes ascending
                buf = torch.full((srows, TILE_X), torch.nan)
                buf[:nrows, :ncols] = vol[b, z][src][:, x0 : x0 + ncols]
                t_rows = torch.zeros((WARPS * rows, TILE_X))
                for k in range(taps):  # ascending taps, from +0
                    t_rows = t_rows + ky[k] * buf[warp_rows + k]
                acc = acc + wz[:, z, None, None] * t_rows[None]
            keep = warp_rows < nout
            ys = y0 + warp_rows[keep]
            out[b, :, ys, x0 : x0 + ncols] = acc[:, keep, :ncols]
            written[b, :, ys, x0 : x0 + ncols] += 1
    assert bool((written == 1).all()), "every output is stored by exactly one tile"
    assert not torch.isnan(out).any(), "an output read a place nothing was staged into"
    return out


# (bits, Z, Y, X), sigma (z, y): Y not a multiple of the segment and below
# it, Y 1 and 3 against the 4-row halo, the last segment ragged, the three
# depth routes (segments of 32, 16, 8 rows), X ragged (4-byte copies) and
# below one tile, y taps past the register window, one y tap
_MODEL_CASES = [
    ((2, 16, 70, 64), (3.0, 1.0)), ((3, 12, 20, 40), (0.945, 1.0)), ((2, 16, 1, 36), (3.0, 1.0)),
    ((2, 5, 3, 68), (3.0, 1.0)), ((2, 6, 33, 33), (3.0, 1.0)), ((1, 24, 37, 64), (3.0, 1.0)),
    ((1, 64, 19, 40), (3.0, 1.0)), ((2, 1, 45, 7), (0.0, 1.0)), ((2, 9, 40, 64), (3.0, 2.6)),
    ((2, 4, 35, 36), (3.0, 0.0)),
]


@pytest.mark.parametrize("grid", [1, 5])
@pytest.mark.parametrize("shape,sigma", _MODEL_CASES)
def test_tiling_model_matches_plain(shape, sigma, grid):
    vol = torch.as_tensor(_volume(shape, shape[2] * 7 + shape[3]))
    got = zy_tiling_model(vol, sigma, grid)
    want = fd.zy_lowpass_plain(vol, sigma)
    _assert_close(got, want, vol.abs().max().item(), "tiling model vs plain")


def test_tables_built_once_a_shape():
    """The wrapper's tables for one shape and sigma are built once: the
    second request returns the same tensors."""
    first = fd._zy_tables(7, 23, 3.0, 1.0, torch.device("cpu"))
    again = fd._zy_tables(7, 23, 3.0, 1.0, torch.device("cpu"))
    assert again is first
    deep = fd._zy_tables(70, 23, 3.0, 1.0, torch.device("cpu"))
    assert first.wz.shape == (7, 7) and first.kz is None and first.zmap is None
    assert deep.wz is None and deep.kz.numel() == deep.taps_z == 25
    assert deep.zmap.numel() == 70 + 24 and first.ymap.numel() == 23 + 8
