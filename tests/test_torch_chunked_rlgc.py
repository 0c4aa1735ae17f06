"""The port's lateral-tiled RLGC (merfish3d_tpu_torch.ops.rlgc.chunked_rlgc)
against the reference's chunked_rlgc, on CPU.

A volume that tiles into 3 x 3 retained tiles, so the inner tile has a
halo on all four sides and every seam lies between two solved tiles,
runs 1 and 3 iterations through the port's plain path with the
reference's own splits injected through ``split_fn`` (each tile with its
own seed). Each tile the reference solves is recorded, so the retained
bounds, the halos and the seeds are held equal tile for tile, and the
stitched result is held to the reference within 1e-4 x max, the
tolerance of the untiled solve (test_torch_rlgc.py).
"""

import numpy as np
import pytest
from test_torch_rlgc import reference_splits
from torch_port_common import gaussian_psf, observed_counts

from merfish3d_tpu.ops import rlgc as jrlgc
from merfish3d_tpu_torch.ops import rlgc as trlgc

SHAPE = (8, 96, 96)
CROP = 32
PSF_SHAPE = (5, 7, 7)
SEED = 3


@pytest.mark.parametrize("iters", [1, 3])
def test_chunked_rlgc_with_reference_splits_matches_jax(iters, monkeypatch):
    obs = observed_counts(SHAPE, n=12, seed=6)
    psf = gaussian_psf(PSF_SHAPE)
    solved = []
    reference_rlgc = jrlgc.rlgc

    def recorded(tile, tile_psf, *, seed, **kw):
        solved.append((np.asarray(tile).copy(), seed))
        return reference_rlgc(tile, tile_psf, seed=seed, **kw)

    monkeypatch.setattr(jrlgc, "rlgc", recorded)
    want = jrlgc.chunked_rlgc(obs, psf, crop_yx=CROP, seed=SEED, max_iters=iters)
    got = trlgc.chunked_rlgc(obs, psf, crop_yx=CROP, seed=SEED, max_iters=iters, device="cpu",
                             split_fn=reference_splits)

    tiles = trlgc.chunk_tiles(SHAPE[1], SHAPE[2], CROP, PSF_SHAPE[1], PSF_SHAPE[2])
    bounds = jrlgc._axis_retained_bounds(SHAPE[1], CROP)
    assert len(bounds) == 3
    assert [t[0] for t in tiles] == [(*by, *bx) for by in bounds for bx in bounds]
    assert len(solved) == len(tiles) == 9
    for i, ((_, (ys, ye, xs, xe)), (tile, seed)) in enumerate(zip(tiles, solved)):
        assert seed == SEED + i
        np.testing.assert_array_equal(tile, obs[:, ys:ye, xs:xe])  # the same halo
    (y0, y1, x0, x1), (ys, ye, xs, xe) = tiles[4]
    assert ys < y0 and ye > y1 and xs < x0 and xe > x1  # the inner tile: a halo on all sides

    assert got.shape == obs.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert not np.allclose(got, obs.mean(), rtol=1e-3)  # the solves moved off their flat starts
